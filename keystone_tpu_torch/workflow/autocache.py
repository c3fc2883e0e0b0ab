"""Profile-guided automatic cache insertion.

Counterpart of `keystone_tpu/workflow/autocache.py:37-397` (reference
workflow/AutoCacheRule.scala:12-664): per-node weights (the passes an
operator makes over its input), recomputation counts (`get_runs`,
reference :57-81), sampled profiles at several scales extrapolated
linearly to the full size (`profile_nodes`, reference :104-135, 153-469),
and the `aggressive` (cache anything used more than once, :503-519) and
`greedy` (best marginal saving under a memory budget, :559-605)
strategies. "Memory" is the bytes the saved expression pins (device
memory for device datasets, host memory for host ones); the saving is
the time of re-running the producing subgraph.

Caching inserts a `CacheMarker` node, which is ``saveable``, so the
prefix table keeps its input across executors (≈ `Cacher`), and records
one ``cache`` decision in the ledger (`:300-330`), the greedy loop's
scored menu as its alternatives. Profiles are measured by the shared
node-force instrumentation (`telemetry/instrument.py`, through
`utils/profiling.py::ExecutionProfiler`, as JAX's `:156`): each
profiled force is closed by a device sync. The default budget reads the
card's free memory from `torch.cuda.mem_get_info`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import ledger
from .analysis import ancestors, children, linearize
from .graph import Graph, NodeId, SinkId, SourceId
from .operators import DatasetOperator, Operator, TransformerOperator
from .optimizer import Plan, Rule

logger = logging.getLogger(__name__)


class CacheMarker(TransformerOperator):
    """Identity node that materializes and prefix-memoizes its input
    (≈ Cacher, nodes/util/Cacher.scala:15-25)."""

    chunkable = True  # per-item: distributes over chunks

    saveable = True

    def __init__(self, name: str = ""):
        self.name = name

    @property
    def label(self) -> str:
        return f"Cache[{self.name}]"

    def single_transform(self, inputs):
        return inputs[0]

    def batch_transform(self, inputs):
        data = inputs[0]
        return data.cache() if hasattr(data, "cache") else data


@dataclass
class Profile:
    """Per-node profile: nanoseconds and output bytes (reference
    AutoCacheRule.scala:12-14, whose two memory figures, Spark's cached
    RDD and its collected results, are one here)."""

    ns: float
    mem_bytes: float

    def __add__(self, other: "Profile") -> "Profile":
        return Profile(self.ns + other.ns, self.mem_bytes + other.mem_bytes)


def node_weight(op: Operator) -> int:
    """The passes the operator makes over its inputs (WeightedNode; a
    BCD solver declares 3·numIter+1, BlockLinearMapper.scala:205-210)."""
    return int(getattr(op, "weight", 1))


def get_runs(graph: Graph, cached: set) -> Dict[NodeId, int]:
    """Recomputation count per node under lazy re-execution (reference
    AutoCacheRule.scala:57-81): a node runs once per pass each dependent
    makes, unless its output is cached (then its demand is 1)."""
    runs: Dict[NodeId, int] = {}
    # users before their dependencies: each node's children are counted
    for n in reversed(linearize(graph)):
        if not isinstance(n, NodeId):
            continue
        total = sum(1 if isinstance(c, SinkId)
                    else runs[c] * node_weight(graph.get_operator(c))
                    for c in children(graph, n))
        runs[n] = 1 if n in cached else max(total, 1)
    return runs


def profile_nodes(graph: Graph, targets: List[NodeId],
                  scales: Tuple[int, ...] = (2, 4)) -> Dict[NodeId, Profile]:
    """Run the ancestors of each target on per-shard samples at several
    scales and extrapolate time and memory linearly to the full data size
    (reference `profileNodes`:153-469, `generalizeProfiles`:104-135).
    Nodes are forced in topological order, so each node's reading holds
    its own work only: its ancestors are already forced."""
    from ..utils.profiling import profile_execution
    from .executor import GraphExecutor

    full_scale = 1
    for op in graph.operators.values():
        if isinstance(op, DatasetOperator) and hasattr(op.dataset,
                                                       "per_shard_count"):
            full_scale = max(full_scale, op.dataset.per_shard_count)

    measurements: Dict[int, Dict[NodeId, Profile]] = {}
    for scale in scales:
        sampled = graph
        for node in graph.operators:
            op = graph.get_operator(node)
            if isinstance(op, DatasetOperator) and hasattr(op.dataset,
                                                           "sample_per_shard"):
                sampled = sampled.set_operator(
                    node, DatasetOperator(op.dataset.sample_per_shard(scale)))
        executor = GraphExecutor(sampled, optimize=False)
        with profile_execution() as collector:
            for target in targets:
                order = [v for v in sorted(
                    ancestors(sampled, target) | {target},
                    key=lambda v: v.id if not isinstance(v, SourceId) else -1)
                    if isinstance(v, NodeId)]
                for v in order:
                    executor.execute(v).get  # noqa: B018 (forces the node)
        measurements[scale] = {
            node: Profile(m.seconds * 1e9, m.bytes)
            for node in sampled.operators
            for m in [collector.by_vertex.get(node.id)]
            if m is not None and m.forced}

    profiles: Dict[NodeId, Profile] = {}
    for node in targets:
        xs = [s for s in scales if node in measurements.get(s, {})]
        if not xs:
            continue
        ys_t = [measurements[s][node].ns for s in xs]
        ys_m = [measurements[s][node].mem_bytes for s in xs]
        if len(xs) >= 2 and xs[0] != xs[-1]:
            bt, at = np.polyfit(xs, ys_t, 1)
            bm, am = np.polyfit(xs, ys_m, 1)
            profiles[node] = Profile(max(at + bt * full_scale, ys_t[-1]),
                                     max(am + bm * full_scale, ys_m[-1]))
        else:
            ratio = full_scale / max(xs[-1], 1)
            profiles[node] = Profile(ys_t[-1] * ratio, ys_m[-1] * ratio)
    return profiles


def estimate_cached_run_time(graph: Graph, cached: set,
                             profiles: Dict[NodeId, Profile]) -> float:
    """Expected total time under a cache set (reference
    `estimateCachedRunTime`:471-490)."""
    runs = get_runs(graph, cached)
    return sum(p.ns * runs[n] for n, p in profiles.items()
               if n in graph.operators)


def device_budget_bytes() -> float:
    """75% of the card's free memory (the reference's default share of
    the cluster's memory), or 1 GiB without a card."""
    import torch

    if torch.cuda.is_available():
        free, _ = torch.cuda.mem_get_info()
        return 0.75 * free
    return float(1 << 30)


class AutoCacheRule(Rule):
    """Insert CacheMarkers by strategy:

    - ``aggressive``: cache every node whose output is demanded more than
      once (reference `aggressiveCache`:503-519); no profiling.
    - ``greedy``: profile the candidates, then repeatedly cache the node
      with the best marginal saving that fits the remaining memory budget
      (reference `greedyCache`:559-605); the default budget is
      `device_budget_bytes`.
    """

    def __init__(self, strategy: str = "greedy",
                 mem_budget_bytes: Optional[int] = None):
        if strategy not in ("aggressive", "greedy"):
            raise ValueError(f"unknown caching strategy {strategy!r}")
        self.strategy = strategy
        self.mem_budget_bytes = mem_budget_bytes
        #: the nodes the last `apply` cached, each with its label
        self.chosen: List[Tuple[NodeId, str]] = []

    def _budget(self) -> float:
        if self.mem_budget_bytes is not None:
            return float(self.mem_budget_bytes)
        return device_budget_bytes()

    @staticmethod
    def _candidates(graph: Graph) -> List[NodeId]:
        """Nodes worth caching: demanded more than once and not already
        cached."""
        runs = get_runs(graph, set())
        out = []
        for n in sorted(graph.operators, key=lambda n: n.id):
            op = graph.get_operator(n)
            if isinstance(op, (CacheMarker, DatasetOperator)):
                continue
            kids = children(graph, n)
            if any(isinstance(graph.get_operator(c), CacheMarker)
                   for c in kids if isinstance(c, NodeId)):
                continue
            demand = sum(1 if isinstance(c, SinkId)
                         else runs[c] * node_weight(graph.get_operator(c))
                         for c in kids)
            if demand > 1:
                out.append(n)
        return out

    @staticmethod
    def _insert_cache(graph: Graph, node: NodeId) -> Graph:
        """Splice a CacheMarker between ``node`` and all its users."""
        g, cache_id = graph.add_node(
            CacheMarker(graph.get_operator(node).label), [node])
        dd = {m: tuple(cache_id if (d == node and m != cache_id) else d
                       for d in deps)
              for m, deps in g.dependencies.items()}
        sd = {s: (cache_id if d == node else d)
              for s, d in g.sink_dependencies.items()}
        return Graph(g.sources, sd, g.operators, dd)

    def _cache(self, graph: Graph, nodes) -> Graph:
        self.chosen = [(n, graph.get_operator(n).label)
                       for n in sorted(nodes, key=lambda n: n.id)]
        for n in sorted(nodes, key=lambda n: -n.id):
            graph = self._insert_cache(graph, n)
        return graph

    @staticmethod
    def _record_cache_decision(graph: Graph, node: NodeId, chosen: Dict,
                               alternatives: List[Dict],
                               predicted: Dict) -> None:
        """One ledger record per cache point (kind ``cache``)."""
        ledger.record_decision(
            kind="cache",
            rule="AutoCacheRule",
            vertices=[node.id],
            labels=[graph.get_operator(node).label],
            chosen=chosen,
            alternatives=alternatives or [{"entry": "no_cache",
                                           "saving_ns": 0.0}],
            predicted=predicted,
        )

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        candidates = self._candidates(graph)
        if not candidates:
            self.chosen = []
            return plan
        if self.strategy == "aggressive":
            runs = get_runs(graph, set())
            for n in sorted(candidates, key=lambda n: -n.id):
                self._record_cache_decision(
                    graph, n,
                    chosen={"entry": "cache", "strategy": "aggressive",
                            "runs_collapsed": runs.get(n, 1)},
                    alternatives=[{"entry": "no_cache",
                                   "runs": runs.get(n, 1)}],
                    predicted={"runs_collapsed": runs.get(n, 1)})
            return self._cache(graph, candidates), prefixes

        profiles = profile_nodes(graph, candidates)
        budget = self._budget()
        cached: set = set()
        used = 0.0
        #: node -> the scored menu of the greedy iteration that chose it
        chosen_menus: Dict[NodeId, List[Dict]] = {}
        #: node -> its own predicted marginal saving at selection time
        chosen_savings: Dict[NodeId, float] = {}
        while True:
            current = estimate_cached_run_time(graph, cached, profiles)
            best, best_saving = None, 0.0
            menu: List[Dict] = []
            for n in candidates:
                p = profiles.get(n)
                if n in cached or p is None or used + p.mem_bytes > budget:
                    continue
                saving = current - estimate_cached_run_time(
                    graph, cached | {n}, profiles)
                menu.append({"entry": f"cache_{n.id}",
                             "label": graph.get_operator(n).label,
                             "saving_ns": float(saving),
                             "mem_bytes": float(p.mem_bytes)})
                if saving > best_saving:
                    best, best_saving = n, saving
            if best is None:
                break
            cached.add(best)
            used += profiles[best].mem_bytes
            chosen_menus[best] = [m for m in menu
                                  if m["entry"] != f"cache_{best.id}"]
            chosen_savings[best] = float(best_saving)
        logger.info("AutoCacheRule(greedy): caching %s", sorted(cached))
        for n in sorted(cached, key=lambda n: -n.id):
            p, saving = profiles[n], chosen_savings[n]
            self._record_cache_decision(
                graph, n,
                chosen={"entry": "cache", "strategy": "greedy",
                        "saving_ns": saving, "mem_bytes": float(p.mem_bytes)},
                alternatives=chosen_menus.get(n, []),
                predicted={"saving_ns": saving,
                           "mem_bytes": float(p.mem_bytes),
                           "budget_bytes": float(budget)})
        return self._cache(graph, cached), prefixes
