"""Sharding-aware plan optimizer: placement as an optimizer decision.

Counterpart of `keystone_tpu/analysis/planner.py:1-814`. The static
tier (`sharding.py`) gives every stage boundary a placement and prices
its collectives; this module chooses the placement:

  - **menu** — a stage's legal placement *families*: rows over
    ``data`` (`FAMILY_DATA`), columns over ``model`` (`FAMILY_MODEL`),
    both (`FAMILY_DATA_MODEL`), and replicated (`FAMILY_REPLICATED`). A
    family is legal where the layout has its axes and every element
    leaf's width divides the model axis, the rule `Dataset` places
    tiles by.
  - **cost** — a boundary whose producer and consumer families differ
    prices the collective relaying it (`transition_cost`, plus a fixed
    penalty a move, so fewer moves win ties); an unmet
    ``abstract_sharding`` demand prices what KP601 reports; a host
    consumer of sharded data prices KP603's all-gather; a replicated
    stage over KP602's threshold with a shardable axis prices a
    broadcast; a family whose per-card residency busts the KP600 budget
    is infeasible (pruned).
  - **solver** — a min-cost DP along the fan-out-free chains of the
    plan, greedy at fan-in, then the uniform data-parallel assignment
    and a bounded coordinate descent, every candidate scored by the one
    function that scores the default.

The plan never loses to the default placement: where the optimum does
not strictly beat it, the plan is the default and nothing is enforced
(``improved`` False). Every price comes from `parallel/mesh.py::
collective_cost`, whose bytes are JAX's and whose seconds are at the
card-to-card rate (`cost_model.NETWORK_WEIGHT`).

The layout is any `parallel/mesh.py::layout_of` argument: a live mesh,
``{"data": d, "model": m}``, or None (the current one; one card without
a process group, where there is nothing to decide and `plan_sharding`
returns None, as JAX's does on a one-device mesh). Pure spec arithmetic;
`workflow/optimizer.py::ShardingPlannerRule` enforces a plan.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..parallel import mesh as meshlib
from ..parallel.mesh import CollectiveCost, P, collective_cost  # noqa: F401
from ..workflow.graph import Graph, GraphId, NodeId, SinkId, SourceId
from .propagate import _label, toposort
from .sharding import (
    DEFAULT_REPLICATED_THRESHOLD,
    DEMAND_DATA_SHARDED,
    DEMAND_REPLICATED,
    PartitionRule,
    ShardedValue,
    ShardingResult,
    _is_host_stage,
    _shardable_axis,
    per_device_bytes,
    sharding_pass,
    spec_str,
)
from .specs import DataSpec, element_nbytes, is_known, tree_leaves

#: the placement menu (`:77-83`)
FAMILY_DATA = "data"
FAMILY_DATA_MODEL = "data_model"
FAMILY_MODEL = "model"
FAMILY_REPLICATED = "replicated"
MENU: Tuple[str, ...] = (
    FAMILY_DATA, FAMILY_DATA_MODEL, FAMILY_MODEL, FAMILY_REPLICATED)

#: objective bytes charged per boundary move besides its payload (`:89`)
RESHARD_PENALTY_BYTES = 64 << 10

_INF = float("inf")


# ------------------------------------------------------------------ families


def _family_leaf_spec(family: str, leaf, mesh, kind: str):
    """The batch-level spec ``family`` gives one element leaf, or None
    where the leaf cannot take it (`:97-115`)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if kind != "dataset":
        return None
    if family == FAMILY_DATA:
        return P(meshlib.DATA_AXIS)
    if family == FAMILY_REPLICATED:
        return P()
    model = int(mesh.shape.get(meshlib.MODEL_AXIS, 1))
    if model <= 1 or not shape or int(shape[0]) % model != 0:
        return None
    if family == FAMILY_MODEL:
        return P(None, meshlib.MODEL_AXIS)
    if family == FAMILY_DATA_MODEL:
        return P(meshlib.DATA_AXIS, meshlib.MODEL_AXIS)
    raise ValueError(f"unknown placement family {family!r}")


def _tree_unflatten_like(tree, it):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_unflatten_like(sub, it) for sub in tree)
    if isinstance(tree, dict):
        vals = {k: _tree_unflatten_like(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    return next(it)


def realize_family(family: str, spec: DataSpec,
                   mesh) -> Optional[ShardedValue]:
    """The `ShardedValue` ``family`` gives a stage's value, or None
    where a leaf cannot take it (`:118-129`)."""
    mesh = meshlib.layout_of(mesh)
    leaves = tree_leaves(spec.element)
    leaf_specs = [_family_leaf_spec(family, l, mesh, spec.kind)
                  for l in leaves]
    if any(s is None for s in leaf_specs):
        return None
    return ShardedValue(_tree_unflatten_like(spec.element, iter(leaf_specs)),
                        kind=spec.kind)


def family_of(sv: Optional[ShardedValue], mesh=None) -> Optional[str]:
    """The menu family a propagated placement is, or None where it is
    none of them (`:132-157`)."""
    if sv is None or sv.kind != "dataset":
        return None
    fams = set()
    for lspec in sv.leaf_specs():
        axes = meshlib.spec_axes(lspec)
        entries = tuple(lspec)
        lead = entries[0] if entries else None
        if isinstance(lead, (tuple, list)):
            lead = lead[0] if lead else None
        if not axes:
            fams.add(FAMILY_REPLICATED)
        elif lead == meshlib.DATA_AXIS and meshlib.MODEL_AXIS in axes:
            fams.add(FAMILY_DATA_MODEL)
        elif lead == meshlib.DATA_AXIS:
            fams.add(FAMILY_DATA)
        elif meshlib.MODEL_AXIS in axes and meshlib.DATA_AXIS not in axes:
            fams.add(FAMILY_MODEL)
        else:
            return None
    if len(fams) != 1:
        return None
    return fams.pop()


def family_shards(family: Optional[str], mesh=None) -> int:
    """Shards ``family`` splits a value into over the layout
    (`:160-169`)."""
    layout = meshlib.layout_of(mesh)
    data = int(layout.shape.get(meshlib.DATA_AXIS, 1))
    model = int(layout.shape.get(meshlib.MODEL_AXIS, 1))
    return {
        FAMILY_DATA: data,
        FAMILY_MODEL: model,
        FAMILY_DATA_MODEL: data * model,
        FAMILY_REPLICATED: 1,
        None: 1,
    }[family]


# --------------------------------------------------------------------- costs


def _effective_input_family(v_fam: str, u_spec, mesh) -> str:
    """The layout a consumer of family ``v_fam`` needs its input in
    (`:175-190`): a column family the input's element cannot take asks
    only for its rows."""
    if v_fam in (FAMILY_DATA, FAMILY_REPLICATED):
        return v_fam
    if isinstance(u_spec, DataSpec) and \
            realize_family(v_fam, u_spec, mesh) is not None:
        return v_fam
    return FAMILY_DATA if v_fam == FAMILY_DATA_MODEL else FAMILY_REPLICATED


def transition_cost(u_fam: Optional[str], v_fam: Optional[str],
                    nbytes: Optional[int], mesh=None,
                    u_spec=None) -> Optional[CollectiveCost]:
    """The collective relaying a producer's output from its family to
    the layout its consumer's family needs (`:193-220`), or None where
    the boundary is free: a matching layout, or a replicated producer.
    A gather into replication is an all-gather, anything else an
    all-to-all of the boundary bytes."""
    if u_fam is None or v_fam is None or not nbytes:
        return None
    mesh = meshlib.layout_of(mesh)
    eff = _effective_input_family(v_fam, u_spec, mesh)
    if u_fam == eff:
        return None
    if u_fam == FAMILY_REPLICATED:
        return None  # each card slices the whole value it holds
    if eff == FAMILY_REPLICATED:
        return collective_cost("all_gather", nbytes,
                               shards=family_shards(u_fam, mesh), mesh=mesh)
    return collective_cost(
        "all_to_all", nbytes,
        shards=max(family_shards(u_fam, mesh), family_shards(eff, mesh)),
        mesh=mesh)


def _transition_bytes(u_fam, v_fam, nbytes, mesh, u_spec=None) -> float:
    cost = transition_cost(u_fam, v_fam, nbytes, mesh, u_spec=u_spec)
    return float(cost.bytes_moved) if cost is not None else 0.0


def demand_cost(demand: Optional[str], fam: Optional[str],
                nbytes: Optional[int], mesh=None
                ) -> Optional[CollectiveCost]:
    """KP601's demand price (`:233-257`), or None where the demand is
    met: a sharding demand an all-to-all between layouts, a replication
    demand an all-gather of the whole value."""
    if demand is None or fam is None or not nbytes:
        return None
    mesh = meshlib.layout_of(mesh)
    data = int(mesh.shape.get(meshlib.DATA_AXIS, 1))
    bad = (
        demand == DEMAND_DATA_SHARDED and data > 1
        and fam not in (FAMILY_DATA, FAMILY_DATA_MODEL)
    ) or (
        demand == DEMAND_REPLICATED and fam != FAMILY_REPLICATED
    )
    if not bad:
        return None
    if demand == DEMAND_REPLICATED:
        return collective_cost("all_gather", nbytes,
                               shards=family_shards(fam, mesh), mesh=mesh)
    return collective_cost("all_to_all", nbytes,
                           shards=max(data, family_shards(fam, mesh)),
                           mesh=mesh)


def _demand_bytes(demand, fam, nbytes, mesh) -> float:
    cost = demand_cost(demand, fam, nbytes, mesh)
    return float(cost.bytes_moved) if cost is not None else 0.0


def _with_penalty(move_bytes: float) -> float:
    """One boundary move's objective: its bytes plus the fixed penalty;
    no move, no penalty (`:268-273`)."""
    return move_bytes + RESHARD_PENALTY_BYTES if move_bytes else 0.0


def gather_cost(fam: Optional[str], nbytes: Optional[int], mesh=None
                ) -> Optional[CollectiveCost]:
    """KP603's price (`:276-282`): a host consumer of sharded data
    all-gathers every shard."""
    if fam is None or fam == FAMILY_REPLICATED or not nbytes:
        return None
    return collective_cost("all_gather", nbytes,
                           shards=family_shards(fam, mesh), mesh=mesh)


def _gather_bytes(fam, nbytes, mesh) -> float:
    cost = gather_cost(fam, nbytes, mesh)
    return float(cost.bytes_moved) if cost is not None else 0.0


class _CostModel:
    """The planner's priced view of one graph (`:290-477`): menus,
    node costs (KP600 feasibility, KP602's broadcast), the hooks'
    demands, and the one scorer of every assignment."""

    def __init__(self, graph: Graph, specs: Dict[GraphId, Any], mesh,
                 hbm_budget_bytes: Optional[int],
                 replicated_threshold_bytes: int):
        self.graph = graph
        self.specs = specs
        self.mesh = meshlib.layout_of(mesh)
        self.budget = hbm_budget_bytes
        self.threshold = replicated_threshold_bytes
        order, _ = toposort(graph)
        self.order = [v for v in order if not isinstance(v, SinkId)]
        # boundaries of an unbound source carry no count: price them at
        # the graph's largest known count, else a stand-in
        known_counts = [s.count for s in specs.values()
                        if isinstance(s, DataSpec) and s.kind == "dataset"
                        and s.count]
        self.nominal_count = max(known_counts, default=1024)
        self.menus: Dict[GraphId, Dict[str, ShardedValue]] = {}
        for vid in self.order:
            spec = specs.get(vid)
            if not self._choosable_spec(spec):
                continue
            menu = {}
            for fam in MENU:
                sv = realize_family(fam, spec, self.mesh)
                if sv is not None:
                    menu[fam] = sv
            if menu:
                self.menus[vid] = menu
        self._demands: Dict[GraphId, Tuple[Optional[str], ...]] = {}
        self._host: Dict[GraphId, bool] = {}

    def _choosable_spec(self, spec) -> bool:
        if not isinstance(spec, DataSpec) or spec.kind != "dataset":
            return False
        if not spec.on_device or not is_known(spec.element):
            return False
        return self.vbytes(spec) is not None

    def vbytes(self, spec) -> Optional[int]:
        """A boundary's priced size: its bytes where the count is known,
        else an element's bytes times the nominal count."""
        if not isinstance(spec, DataSpec):
            return None
        if spec.nbytes is not None:
            return spec.nbytes
        if spec.kind != "dataset":
            return None
        per = element_nbytes(spec.element)
        if per is None:
            return None
        return per * self.nominal_count

    def data_deps(self, vid) -> List[GraphId]:
        if isinstance(vid, SourceId):
            return []
        deps = self.graph.get_dependencies(vid)
        return [d for d in deps if isinstance(self.specs.get(d), DataSpec)]

    def demands(self, vid, assignment) -> Tuple[Optional[str], ...]:
        """The operator's ``abstract_sharding`` demands, read once (a
        raising hook has none here; the lint's KP605 reports it)."""
        if vid in self._demands:
            return self._demands[vid]
        out: Tuple[Optional[str], ...] = ()
        if isinstance(vid, NodeId):
            op = self.graph.get_operator(vid)
            hook = getattr(op, "abstract_sharding", None)
            if hook is not None:
                deps = self.graph.get_dependencies(vid)
                in_shardings = [assignment.get(d) for d in deps]
                in_specs = [self.specs.get(d) for d in deps]
                try:
                    res = hook(in_shardings, in_specs)
                    if isinstance(res, ShardingResult):
                        out = tuple(res.demands)
                except Exception:
                    out = ()
        self._demands[vid] = out
        return out

    def is_host(self, vid) -> bool:
        got = self._host.get(vid)
        if got is None:
            got = isinstance(vid, NodeId) and _is_host_stage(
                self.graph, vid, self.specs)
            self._host[vid] = got
        return got

    def node_cost(self, vid, fam: str) -> float:
        """Holding this stage in ``fam``: INF where a card's residency
        busts the KP600 budget, plus KP602's broadcast for a large
        replicated value with a shardable axis."""
        spec = self.specs.get(vid)
        sv = self.menus[vid][fam]
        cost = 0.0
        if self.budget:
            pd = per_device_bytes(spec, sv, self.mesh)
            if pd is not None and pd > self.budget:
                return _INF
        if fam == FAMILY_REPLICATED and spec.nbytes \
                and spec.nbytes >= self.threshold \
                and _shardable_axis(spec, self.mesh) is not None:
            cost += float(collective_cost(
                "broadcast", spec.nbytes, shards=self.mesh.size,
                mesh=self.mesh).bytes_moved)
        return cost

    def score(self, families: Dict[GraphId, str]) -> Tuple[
            float, float, Dict[NodeId, int]]:
        """``(objective, bytes_total, boundary)`` of one assignment
        (`:415-477`): ``boundary`` the pure collective bytes charged at
        each consumer, ``bytes_total`` their sum, ``objective`` also the
        per-move penalties and INF where infeasible."""
        assignment = {vid: self.menus[vid][fam]
                      for vid, fam in families.items() if vid in self.menus}
        objective = 0.0
        bytes_total = 0.0
        boundary: Dict[NodeId, int] = {}

        def charge(vid, move_bytes: float, penalized: bool = True) -> None:
            nonlocal objective, bytes_total
            if not move_bytes:
                return
            objective += (_with_penalty(move_bytes) if penalized
                          else move_bytes)
            if move_bytes != _INF:
                bytes_total += move_bytes
                if isinstance(vid, NodeId):
                    boundary[vid] = boundary.get(vid, 0) + int(move_bytes)

        for vid in self.order:
            fam_v = families.get(vid)
            if fam_v is not None and vid in self.menus:
                charge(vid, self.node_cost(vid, fam_v), penalized=False)
            deps = self.data_deps(vid)
            demands = self.demands(vid, assignment)
            all_deps = (list(self.graph.get_dependencies(vid))
                        if isinstance(vid, NodeId) else [])
            for d in deps:
                fam_u = families.get(d)
                u_spec = self.specs.get(d)
                nbytes = self.vbytes(u_spec)
                if self.is_host(vid):
                    charge(vid, _gather_bytes(fam_u, nbytes, self.mesh),
                           penalized=False)
                    continue
                demand = None
                if demands:
                    try:
                        i = all_deps.index(d)
                    except ValueError:
                        i = -1
                    if 0 <= i < len(demands):
                        demand = demands[i]
                if demand is not None:
                    charge(vid, _demand_bytes(
                        demand, fam_u, nbytes, self.mesh))
                elif fam_v is not None:
                    charge(vid, _transition_bytes(
                        fam_u, fam_v, nbytes, self.mesh, u_spec=u_spec))
        return objective, bytes_total, boundary


# ---------------------------------------------------------------------- plan


@dataclass
class ShardingPlan:
    """The planner's decision (`:483-564`): the chosen placements, the
    default they were scored against, and both priced totals. When
    ``improved`` is False the choices are the default and nothing is
    enforced."""

    mesh: Any
    families: Dict[GraphId, str]
    default_families: Dict[GraphId, str]
    choices: Dict[GraphId, ShardedValue]
    default_shardings: Dict[GraphId, Optional[ShardedValue]]
    planned_cost_bytes: float
    default_cost_bytes: float
    planned_boundary: Dict[NodeId, int] = field(default_factory=dict)
    default_boundary: Dict[NodeId, int] = field(default_factory=dict)
    #: every complete assignment the solver scored: ``[{"entry",
    #: "objective", "cost_bytes"}, ...]``, the ledger's alternatives
    scored_candidates: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def improved(self) -> bool:
        return self.planned_cost_bytes < self.default_cost_bytes

    @property
    def savings_bytes(self) -> int:
        return max(0, int(self.default_cost_bytes - self.planned_cost_bytes))

    def changed_vertices(self) -> List[GraphId]:
        return [vid for vid, fam in sorted(
                    self.families.items(),
                    key=lambda kv: getattr(kv[0], "id", -1))
                if self.default_families.get(vid) != fam]

    def spec_for(self, vid):
        """The batch-level spec the plan pins on ``vid``'s output (its
        first leaf: every enforced output is one tensor)."""
        sv = self.choices.get(vid)
        if sv is None:
            return None
        leaves = sv.leaf_specs()
        return leaves[0] if leaves else None

    def partition_rules(self, graph: Graph) -> List[PartitionRule]:
        """The changed choices as anchor-exact `PartitionRule`s."""
        rules = []
        for vid in self.changed_vertices():
            if not isinstance(vid, NodeId):
                continue
            spec = self.spec_for(vid)
            if spec is None:
                continue
            anchor = f"{_label(graph, vid)}@{vid}"
            rules.append(PartitionRule(f"^{re.escape(anchor)}$", spec))
        return rules

    def rows(self, graph: Graph) -> List[Dict[str, Any]]:
        """Chosen against default placement a stage (topological order),
        the ``--explain-sharding --plan`` rows."""
        order, _ = toposort(graph)
        changed = set(self.changed_vertices())
        rows = []
        for vid in order:
            if not isinstance(vid, NodeId):
                continue
            chosen = self.choices.get(vid, self.default_shardings.get(vid))
            rows.append({
                "vertex": vid.id,
                "label": _label(graph, vid),
                "default_spec": spec_str(self.default_shardings.get(vid)),
                "chosen_spec": spec_str(chosen),
                "changed": vid in changed,
                "default_boundary_bytes": self.default_boundary.get(vid, 0),
                "planned_boundary_bytes": self.planned_boundary.get(vid, 0),
            })
        return rows


def format_plan(rows: List[Dict[str, Any]]) -> str:
    """Text table of `ShardingPlan.rows` (`:567-577`)."""
    lines = [f"{'stage':<38} {'default':<20} {'chosen':<20} {'Δbytes':>12}"]
    for r in rows:
        delta = r["default_boundary_bytes"] - r["planned_boundary_bytes"]
        mark = "*" if r["changed"] else " "
        name = f"{r['label']}@{r['vertex']}"
        col = f"{delta:+,d}" if delta else "—"
        lines.append(
            f"{name[:38]:<38} {r['default_spec'][:20]:<20} "
            f"{mark}{r['chosen_spec'][:19]:<19} {col:>12}")
    return "\n".join(lines)


# ------------------------------------------------------------------- solver


def plan_sharding(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    mesh=None,
    hbm_budget_bytes: Optional[int] = None,
    replicated_threshold_bytes: int = DEFAULT_REPLICATED_THRESHOLD,
) -> Optional[ShardingPlan]:
    """The placement minimizing priced boundary bytes (`:583-814`), or
    None where there is nothing to decide: one card, or no stage with a
    known device dataset boundary. The DP's optimum and the default are
    scored by the same function and the better one is returned."""
    mesh = meshlib.layout_of(mesh)
    if mesh.size <= 1:
        return None
    model = _CostModel(graph, specs, mesh, hbm_budget_bytes,
                       replicated_threshold_bytes)
    if not model.menus:
        return None

    # the default placement as families; a stage whose default is no
    # family is left out of the choice
    default_shardings, _, _ = sharding_pass(graph, specs, mesh=mesh)
    default_families: Dict[GraphId, str] = {}
    for vid in list(model.menus):
        fam = family_of(default_shardings.get(vid), mesh)
        if fam is None or fam not in model.menus[vid]:
            del model.menus[vid]
        else:
            default_families[vid] = fam
    if not model.menus:
        return None

    graph_users = {vid: [u for u in graph.users_of(vid)
                         if not isinstance(u, SinkId)]
                   for vid in model.order}

    dp: Dict[GraphId, Dict[str, float]] = {}
    back: Dict[GraphId, Dict[str, Optional[str]]] = {}
    chain_parent: Dict[GraphId, GraphId] = {}
    frozen: Dict[GraphId, str] = {}

    def menu_rank(vid, fam) -> Tuple:
        # ties prefer the default family, then menu order, so a planner
        # with nothing to win reproduces the default exactly
        return (0 if fam == default_families.get(vid) else 1,
                MENU.index(fam))

    def freeze(vid, extra=None) -> None:
        """Fix ``vid``'s family (the greedy frontier merge), biased by
        its freezing consumer's ``extra(family)``, and walk the chain's
        backpointers upstream."""
        if vid in frozen or vid not in dp:
            return
        table = dp[vid]
        best = min(table, key=lambda f: (
            table[f] + (extra(f) if extra else 0.0),) + menu_rank(vid, f))
        if table[best] == _INF:
            best = default_families[vid]  # every entry infeasible
        cur, fam = vid, best
        while cur is not None:
            frozen[cur] = fam
            parent = chain_parent.get(cur)
            fam = back.get(cur, {}).get(fam) if parent is not None else None
            if parent is not None and fam is None:
                # an all-INF chain: keep the default, score() prices INF
                fam = default_families[parent]
            cur = parent

    for vid in model.order:
        deps = model.data_deps(vid)
        choosable_deps = [d for d in deps if d in model.menus]
        if vid in model.menus:
            chain = None
            if len(choosable_deps) == 1:
                (u,) = choosable_deps
                if len(graph_users.get(u, ())) == 1 and u in dp \
                        and u not in frozen:
                    chain = u
            for d in choosable_deps:
                if d is not chain:
                    freeze(d)
            table: Dict[str, float] = {}
            bptr: Dict[str, Optional[str]] = {}
            for fam in model.menus[vid]:
                node = model.node_cost(vid, fam)
                if chain is not None:
                    u_spec = model.specs.get(chain)
                    u_bytes = model.vbytes(u_spec)
                    best_g, best_cost = None, _INF
                    for g, gc in dp[chain].items():
                        c = gc + _with_penalty(_transition_bytes(
                            g, fam, u_bytes, mesh, u_spec=u_spec))
                        if c < best_cost or (
                                c == best_cost and best_g is not None
                                and menu_rank(chain, g)
                                < menu_rank(chain, best_g)):
                            best_g, best_cost = g, c
                    table[fam] = best_cost + node
                    bptr[fam] = best_g
                else:
                    base = 0.0
                    for d in choosable_deps:
                        d_spec = model.specs.get(d)
                        base += _with_penalty(_transition_bytes(
                            frozen.get(d), fam, model.vbytes(d_spec),
                            mesh, u_spec=d_spec))
                    table[fam] = base + node
                    bptr[fam] = None
            dp[vid] = table
            back[vid] = bptr
            if chain is not None:
                chain_parent[vid] = chain
        else:
            # a consumer outside the choice ends its producers' chains,
            # which are frozen knowing what it charges
            demands = model.demands(vid, {})
            all_deps = (graph.get_dependencies(vid)
                        if isinstance(vid, NodeId) else ())
            for d in choosable_deps:
                d_bytes = model.vbytes(model.specs.get(d))
                if model.is_host(vid):
                    freeze(d, extra=lambda f, b=d_bytes:
                           _gather_bytes(f, b, mesh))
                elif demands:
                    try:
                        i = list(all_deps).index(d)
                    except ValueError:
                        i = -1
                    demand = demands[i] if 0 <= i < len(demands) else None
                    freeze(d, extra=lambda f, dm=demand, b=d_bytes:
                           _with_penalty(_demand_bytes(dm, f, b, mesh)))
                else:
                    freeze(d)

    for vid in model.order:
        if vid in dp and vid not in frozen:
            freeze(vid)  # chain tails feeding only sinks

    default_obj, default_bytes, default_boundary = model.score(
        default_families)

    # the greedy merge can freeze a shared producer early: the uniform
    # data-parallel assignment as another seed, then a bounded
    # coordinate descent, every candidate by the same scorer
    def pick(fams_a, obj_a, fams_b):
        obj_b, _, _ = model.score(fams_b)
        return (fams_b, obj_b) if obj_b < obj_a else (fams_a, obj_a)

    best_fams = dict(frozen)
    best_obj, dp_bytes, _ = model.score(best_fams)
    uniform = {vid: (FAMILY_DATA if FAMILY_DATA in model.menus[vid]
                     else default_families[vid])
               for vid in model.menus}
    uniform_obj, uniform_bytes, _ = model.score(uniform)
    scored_candidates = [
        {"entry": "default", "objective": float(default_obj),
         "cost_bytes": float(default_bytes)},
        {"entry": "chain_dp", "objective": float(best_obj),
         "cost_bytes": float(dp_bytes)},
        {"entry": "uniform_data", "objective": float(uniform_obj),
         "cost_bytes": float(uniform_bytes)},
    ]
    best_fams, best_obj = pick(best_fams, best_obj, uniform)
    for _sweep in range(3):
        changed = False
        for vid in model.order:
            if vid not in model.menus:
                continue
            for fam in model.menus[vid]:
                if fam == best_fams.get(vid):
                    continue
                trial = dict(best_fams)
                trial[vid] = fam
                trial_obj, _, _ = model.score(trial)
                if trial_obj < best_obj:
                    best_fams, best_obj = trial, trial_obj
                    changed = True
        if not changed:
            break

    frozen = best_fams
    planned_obj, planned_bytes, planned_boundary = model.score(frozen)
    scored_candidates.append(
        {"entry": "local_descent", "objective": float(planned_obj),
         "cost_bytes": float(planned_bytes)})

    # a win must be strict in the objective and in the bytes
    if not (planned_obj < default_obj and planned_bytes < default_bytes):
        frozen = dict(default_families)
        planned_bytes, planned_boundary = default_bytes, default_boundary

    choices = {vid: model.menus[vid][fam] for vid, fam in frozen.items()}
    return ShardingPlan(
        mesh=mesh,
        families=frozen,
        default_families=default_families,
        choices=choices,
        default_shardings=default_shardings,
        planned_cost_bytes=planned_bytes,
        default_cost_bytes=default_bytes,
        planned_boundary=planned_boundary,
        default_boundary=default_boundary,
        scored_candidates=scored_candidates,
    )
