"""Rule engine and the standard optimization rules.

Counterpart of `keystone_tpu/workflow/optimizer.py:41-1043` (reference
workflow/{Rule,RuleExecutor,DefaultOptimizer}.scala and the rules):
  - ExtractSaveablePrefixes + SavedStateLoadRule: fitted-state reuse
    (ExtractSaveablePrefixes.scala:9-22, SavedStateLoadRule.scala:7-20)
  - UnusedBranchRemovalRule: dead-branch elimination
    (UnusedBranchRemovalRule.scala:7-24)
  - EquivalentNodeMergeRule: common-subexpression elimination
    (EquivalentNodeMergeRule.scala:13-48)
  - NodeOptimizationRule: sample-driven node-level implementation choice
    (NodeOptimizationRule.scala:14-198)
  - NodeFusionRule and MegafusionRule (`fusion_rule.py`) and
    AutoCacheRule (`autocache.py`);
  - the planners (`:255-945`): UnifiedPlannerRule (`analysis/plan_ir.py`
    decides, this rule enforces: the chunk, cache points on the card or
    in host memory, precision trails, chain-kernel tags, and on more
    than one card the placement), ShardingPlannerRule
    (`analysis/planner.py` decides the placement across the mesh's
    cards; nothing to place on one card, as JAX's rule on a one-device
    mesh) and PrecisionPlannerRule (`analysis/precision.py`). They price
    on the card's calibrated rates (`calibrate.machine_rates`) and the
    card-to-card rate (`cost_model.NETWORK_WEIGHT`).

A *plan* is ``(Graph, dict[NodeId, Prefix])``, the prefix map holding
only the saveable nodes' structural prefixes.
"""

from __future__ import annotations

import logging
import weakref
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..telemetry import ledger
from ..telemetry.metrics import counter
from ..telemetry.spans import span
from .analysis import ancestors, linearize
from .env import PipelineEnv, Prefix, compute_prefix
from .graph import Graph, NodeId
from .operators import DatasetOperator, ExpressionOperator

_PREFIX_REUSE = counter("executor.prefix_reuse")
# the planners' counters, JAX's names (`:352-355, 877-878`)
_UNIFIED_ENFORCED = counter("planner.unified_plans_enforced")
_UNIFIED_SAVED = counter("planner.unified_seconds_saved")
_BYTES_HALVED = counter("planner.bytes_halved")
_PRECISION_ENFORCED = counter("planner.precision_policies_enforced")
_PLANS_ENFORCED = counter("planner.plans_enforced")
_BOUNDARY_SAVED = counter("planner.boundary_bytes_saved")

logger = logging.getLogger(__name__)

Plan = Tuple[Graph, Dict[NodeId, Prefix]]


class Rule:
    """A plan → plan rewrite (Rule.scala:11-19)."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, plan: Plan) -> Plan:
        raise NotImplementedError


@dataclass
class Batch:
    """A named group of rules with an iteration strategy
    (RuleExecutor.scala:5-27): ``max_iterations=1`` is Once; more is
    FixedPoint."""

    name: str
    rules: List[Rule]
    max_iterations: int = 1


def run_batch(batch: Batch, plan: Plan) -> Plan:
    """``batch``'s rules in order, repeated until the plan stops changing
    or the batch's iteration cap."""
    for _ in range(batch.max_iterations):
        new_plan = plan
        for rule in batch.rules:
            new_plan = rule.apply(new_plan)
        if plans_equal(new_plan, plan):
            break
        plan = new_plan
    return plan


def plans_equal(a: Plan, b: Plan) -> bool:
    ga, gb = a[0], b[0]
    return (ga.sources == gb.sources
            and ga.operators == gb.operators
            and ga.dependencies == gb.dependencies
            and ga.sink_dependencies == gb.sink_dependencies
            and a[1] == b[1])


class RuleExecutor:
    """Runs batches of rules, each to its fixpoint or iteration cap
    (RuleExecutor.scala:29-84)."""

    @property
    def batches(self) -> List[Batch]:
        raise NotImplementedError

    def execute(self, graph: Graph) -> Plan:
        """The batches in order: an ``optimize`` phase span, one
        ``optimizer:<batch>`` span each (JAX's `:72-77`)."""
        plan: Plan = (graph, {})
        with span("optimize", cat="phase", batches=len(self.batches)):
            for batch in self.batches:
                with span(f"optimizer:{batch.name}", cat="phase"):
                    plan = run_batch(batch, plan)
                if logger.isEnabledFor(logging.DEBUG):
                    logger.debug("after batch %s:\n%s", batch.name,
                                 plan[0].to_dot())
        return plan


class ExtractSaveablePrefixes(Rule):
    """Record the structural prefix of every saveable node: estimators
    and cache markers (ExtractSaveablePrefixes.scala:9-22)."""

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        memo: dict = {}
        new_prefixes = dict(prefixes)
        for node, op in graph.operators.items():
            if getattr(op, "saveable", False):
                p = compute_prefix(graph, node, memo)
                if p is not None:
                    new_prefixes[node] = p
        return graph, new_prefixes


class SavedStateLoadRule(Rule):
    """Swap in memoized expressions for nodes whose prefix an earlier
    pipeline already executed (SavedStateLoadRule.scala:7-20)."""

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        env = PipelineEnv.get()
        for node, prefix in list(prefixes.items()):
            expr = env.state.get(prefix)
            if expr is not None and not isinstance(
                    graph.get_operator(node), ExpressionOperator):
                _PREFIX_REUSE.inc()
                graph = graph.set_operator(
                    node, ExpressionOperator(
                        expr, name=str(prefix.operator_key[0]))
                ).set_dependencies(node, ())
        return graph, prefixes


class UnusedBranchRemovalRule(Rule):
    """Remove nodes that no sink transitively depends on
    (UnusedBranchRemovalRule.scala:7-24). Sources are kept: they are the
    pipeline's input contract."""

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        live: set = set()
        for sink in graph.sink_dependencies:
            live |= ancestors(graph, sink)
        dead = [n for n in graph.operators if n not in live]
        # remove in reverse topological order so users go first
        order = {v: i for i, v in enumerate(linearize(graph))}
        for n in sorted(dead, key=lambda n: -order.get(n, 0)):
            graph = graph.remove_node(n)
        prefixes = {n: p for n, p in prefixes.items() if n in graph.operators}
        return graph, prefixes


class EquivalentNodeMergeRule(Rule):
    """CSE: merge nodes with identical (operator key, dependencies)
    (EquivalentNodeMergeRule.scala:13-48), keeping the lowest node id.

    JAX's rule groups the nodes once an application, so one application
    merges one level of a duplicated chain and its batch stops after 10;
    a chain deeper than that (VOCSIFTFisher's training branches) keeps
    duplicates, and a duplicated estimator fits twice. Here the nodes are
    visited in topological order and each merge rewires its users at
    once, so one application reaches the fixpoint; on chains within the
    cap the plans are JAX's."""

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        # equivalence classes in topological order, each node's key over
        # its dependencies' class representatives
        rep: Dict[NodeId, NodeId] = {}
        first: Dict[tuple, NodeId] = {}
        members: Dict[NodeId, List[NodeId]] = {}
        for node in linearize(graph):
            if not isinstance(node, NodeId):
                continue
            key = (graph.get_operator(node).prefix_key(),
                   tuple(rep.get(d, d) for d in graph.get_dependencies(node)))
            rep[node] = first.setdefault(key, node)
            members.setdefault(rep[node], []).append(node)
        drops = {}
        for group in members.values():
            keep = min(group)
            drops.update((n, keep) for n in group if n != keep)
        for drop, keep in drops.items():
            graph = graph.replace_dependency(drop, keep)
        for drop in drops:
            graph = graph.remove_node(drop)
            prefixes.pop(drop, None)
        return graph, prefixes


class NodeOptimizationRule(Rule):
    """Execute the DAG on per-shard samples and let each `Optimizable*`
    node choose its implementation from the sample
    (NodeOptimizationRule.scala:14-198).

    A node opts in with ``optimize_from_sample(sample_inputs,
    num_per_shard) -> Operator``. The sampled graph swaps every
    `DatasetOperator`'s dataset for ``samples_per_shard`` of its items
    (`sample_per_shard`; 3 a partition in the reference); one card is one
    shard."""

    #: sampled items a shard (SampleCollector's default)
    samples_per_shard = 3

    def __init__(self, samples_per_shard: int = 3):
        self.samples_per_shard = samples_per_shard

    def apply(self, plan: Plan) -> Plan:
        graph, prefixes = plan
        targets = [n for n in sorted(graph.operators, key=lambda n: n.id)
                   if hasattr(graph.get_operator(n), "optimize_from_sample")]
        if not targets:
            return plan
        sampled = graph
        num_per_shard: Dict[int, int] = {}
        for node in graph.operators:
            op = graph.get_operator(node)
            if isinstance(op, DatasetOperator) and hasattr(
                    op.dataset, "sample_per_shard"):
                num_per_shard[node.id] = op.dataset.per_shard_count
                sampled = sampled.set_operator(node, DatasetOperator(
                    op.dataset.sample_per_shard(self.samples_per_shard),
                    name=f"sample[{op.name}]"))
        scale = max(num_per_shard.values(), default=self.samples_per_shard)

        from .executor import GraphExecutor

        sample_exec = GraphExecutor(sampled, optimize=False)
        for node in targets:
            op = graph.get_operator(node)
            try:
                sample_inputs = [sample_exec.execute(d).get
                                 for d in sampled.get_dependencies(node)]
            except ValueError:
                continue  # depends on an unbound source; cannot sample
            chosen = op.optimize_from_sample(sample_inputs, scale)
            if chosen is not None and chosen is not op:
                logger.info("NodeOptimizationRule: %s -> %s", op.label,
                            chosen.label)
                graph = graph.set_operator(node, chosen)
        return graph, prefixes


#: resident device-dataset bytes below which the unified planner's
#: solve cannot clear a nonzero enforcement floor (`:248-252`)
UNIFIED_SOLVE_MIN_BYTES = 64 << 10

#: graphs whose precision axis an enforced unified plan owns (`:255-265`):
#: the sequential rules stand down on them. Weak, so a dropped plan
#: releases its entry.
_UNIFIED_OWNED: "weakref.WeakSet" = weakref.WeakSet()


#: graph -> its propagated specs, so the planner rules of one
#: optimization trace a graph once (graphs are immutable)
_SPECS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _specs_of(graph: Graph) -> Dict:
    specs = _SPECS.get(graph)
    if specs is None:
        from ..analysis.propagate import spec_pass

        specs, _ = spec_pass(graph, {})
        _SPECS[graph] = specs
    return specs


def unified_enforced(graph: Graph) -> bool:
    """Whether an enforced unified plan owns this graph's precision axis:
    registered during this optimization, or tagged in an earlier one."""
    return graph in _UNIFIED_OWNED or any(
        getattr(op, "planned_by_unified", False)
        for op in graph.operators.values())


def _has_device_dataset(graph: Graph) -> bool:
    """A plan input whose rows live on a device, or a host-resident one
    that enters the card in windows (`:689-695`)."""
    for op in graph.operators.values():
        if not isinstance(op, DatasetOperator):
            continue
        ds = op.dataset
        if getattr(ds, "is_spilled", False) \
                or getattr(ds, "is_out_of_core", False):
            return True
        data = getattr(ds, "data", None)
        if data is not None and not isinstance(data, list):
            return True
    return False


def _fused_program(op) -> bool:
    from ..nodes.util.fusion import FusedBatchTransformer
    from .fusion_rule import FusedChainOperator

    return isinstance(op, (FusedChainOperator, FusedBatchTransformer))


class UnifiedPlannerRule(Rule):
    """One decision over the storage dtypes, the chunk, the cache points
    (on the card or in host memory) and the chain kernels, priced in
    seconds on the card's calibrated rates under ``hbm_budget_bytes``
    (`analysis/plan_ir.py` decides; this rule enforces; `:281-590`).

    Runs after fusion and megafusion and before the sequential planners.
    A strict no-op with ``ExecutionConfig.unified_planner`` off, on plans
    with no device dataset, on a planner failure (logged, plan
    unchanged, as JAX's), and where the joint plan does not beat the
    sequential one by ``unified_min_savings_seconds``. Otherwise:

      - precision trails become ``planned_precision`` tagged copies
        (``planned_matmul_precision="bfloat16"`` where every stage is
        tolerant) marked ``planned_by_unified``, and the precision rule
        stands down;
      - chain kernels: the chosen slices' tags go on tagged copies; a
        fused transformer tags itself with the same slice anyway;
      - the chunk goes through `env.set_planned_chunk_size`;
      - cache points become `CacheMarker`s, spilled ones
        ``placement="host"``.

    Each enforced decision kind leaves one ledger record whose
    alternatives are the menu entries the solver scored."""

    def apply(self, plan: Plan) -> Plan:
        from .env import execution_config, set_planned_chunk_size

        cfg = execution_config()
        if not cfg.unified_planner:
            return plan
        # every path re-decides the chunk: no bail-out below may leak a
        # previous plan's decision into this one
        set_planned_chunk_size(None)
        graph, prefixes = plan
        if not _has_device_dataset(graph):
            return plan
        if not self._worth_solving(graph, cfg):
            return plan
        with span("unified_planner", cat="phase"):
            try:
                from ..analysis.plan_ir import plan_unified

                uplan = plan_unified(
                    graph, _specs_of(graph), mesh=_current_layout(),
                    hbm_budget_bytes=cfg.hbm_budget_bytes,
                    chunk_default=cfg.chunk_size,
                    include_boundary_policies=False,
                    precision_floor_bytes=cfg.precision_min_savings_bytes)
            except Exception:
                logger.debug("unified planner failed; plan unchanged",
                             exc_info=True)
                return plan
            if uplan is None or not uplan.improved or \
                    uplan.savings_seconds < cfg.unified_min_savings_seconds:
                return plan
            _UNIFIED_ENFORCED.inc()
            _UNIFIED_SAVED.inc(uplan.savings_seconds)
            logger.info(
                "UnifiedPlannerRule: enforcing joint plan, predicted "
                "%.3es -> %.3es (%s)", uplan.sequential_seconds,
                uplan.joint_seconds, ", ".join(uplan.changed_kinds()))
            graph = self._enforce(graph, uplan, cfg)
        return graph, prefixes

    @staticmethod
    def _worth_solving(graph: Graph, cfg) -> bool:
        """Skip the solve where the resident device data are too small
        for any win to clear a nonzero floor and the chunk axis has no
        trips to save (`:362-385`)."""
        if cfg.unified_min_savings_seconds <= 0:
            return True
        device_bytes = 0
        max_rows = 0
        for op in graph.operators.values():
            if not isinstance(op, DatasetOperator):
                continue
            ds = op.dataset
            if getattr(ds, "is_spilled", False) \
                    or getattr(ds, "is_out_of_core", False):
                return True
            data = getattr(ds, "data", None)
            parts = data if isinstance(data, tuple) else (data,)
            for leaf in parts:
                if hasattr(leaf, "element_size") and leaf.dim():
                    device_bytes += leaf.numel() * leaf.element_size()
                    max_rows = max(max_rows, int(leaf.shape[0]))
        return (device_bytes >= UNIFIED_SOLVE_MIN_BYTES
                or max_rows > 4 * cfg.chunk_size)

    def _enforce(self, graph: Graph, uplan, cfg) -> Graph:
        from ..analysis.precision import TOLERANT
        from .autocache import AutoCacheRule
        from .env import set_planned_chunk_size

        kinds = uplan.changed_kinds()
        if "placement" in kinds and uplan.sharding is not None:
            self._record(uplan, "placement",
                         uplan.sharding.changed_vertices(), graph)
            graph = ShardingPlannerRule._enforce(graph, uplan.sharding,
                                                 mark_unified=True)
        if "precision" in kinds:
            for vid, decided in sorted(
                    uplan.program_precision.items(),
                    key=lambda kv: getattr(kv[0], "id", -1)):
                if vid not in graph.operators:
                    continue
                storage, saved, menu = decided
                op = graph.get_operator(vid)
                tags = dict(planned_precision=storage,
                            planned_by_unified=True)
                if PrecisionPlannerRule._all_compute_tolerant(
                        graph, vid, op):
                    tags["planned_matmul_precision"] = "bfloat16"
                graph = graph.set_operator(vid, op.tagged_copy(**tags))
                PrecisionPlannerRule._record_decision(
                    graph, vid, op, storage, saved, menu,
                    rule="UnifiedPlannerRule")
        if "kernel" in kinds:
            self._record(uplan, "kernel", sorted(
                uplan.kernel_choices, key=lambda v: getattr(v, "id", -1)),
                graph)
            for vid, cand in sorted(uplan.kernel_choices.items(),
                                    key=lambda kv: getattr(kv[0], "id", -1)):
                if vid not in graph.operators:
                    continue
                start, stop = cand["stage_slice"]
                family = (cand.get("lowerable") or {}).get("family")
                # the priced seconds ride on the tag to the chain_kernel
                # span, which `analysis/reconcile.py` joins (`:453-460`)
                graph = graph.set_operator(
                    vid, graph.get_operator(vid).tagged_copy(
                        planned_kernel=(int(start), int(stop), family),
                        planned_kernel_seconds=float(cand["kernel_seconds"]),
                        planned_by_unified=True))
        if "chunk" in kinds:
            self._record(uplan, "chunk", [], graph)
            set_planned_chunk_size(uplan.chunk_size)
        spilled = set(uplan.chosen.spills)
        if "cache" in kinds:
            # spilled caches are cache points too: the spill branch
            # places them, never as device caches here
            device_caches = [v for v in uplan.cache_vertices
                             if v not in spilled]
            if device_caches:
                self._record(uplan, "cache", device_caches, graph)
            for vid in sorted(device_caches,
                              key=lambda v: -getattr(v, "id", -1)):
                if vid in graph.operators:
                    graph = AutoCacheRule._insert_cache(graph, vid)
        if "spill" in kinds and cfg.ooc_spill:
            self._record(uplan, "spill", uplan.spill_vertices, graph)
            for vid in sorted(uplan.spill_vertices,
                              key=lambda v: -getattr(v, "id", -1)):
                if vid in graph.operators:
                    graph = AutoCacheRule._insert_cache(
                        graph, vid, placement="host")
        if "precision" in kinds or "placement" in kinds:
            _UNIFIED_OWNED.add(graph)
        return graph

    @staticmethod
    def _record(uplan, kind: str, vertices, graph: Graph) -> None:
        """One ledger record per enforced decision kind: the chosen entry,
        that kind's slice of the scored menu as the alternatives, and the
        predicted seconds (`:503-590`). Never raises."""
        try:
            from ..analysis.propagate import _label

            present = [v for v in vertices if v in graph.operators]
            chosen = {
                "entry": "joint_optimum",
                "predicted_seconds": float(uplan.joint_seconds),
                "chunk_size": int(uplan.chunk_size),
            }
            if kind == "chunk":
                chosen["sequential_chunk_size"] = int(
                    uplan.default_chunk_size)
            if kind == "cache":
                chosen["cache_points"] = [v.id for v in present]
            if kind == "spill":
                chosen["spill_points"] = [v.id for v in present]
                chosen["placement"] = "host"
                chosen["spills"] = [
                    dict(uplan.spill_predictions.get(v, {}), vertex=v.id)
                    for v in present]
            if kind == "kernel":
                chosen["kernels"] = [
                    {"vertex": v.id,
                     "family": (c.get("lowerable") or {}).get("family"),
                     "stage_slice": list(c.get("stage_slice") or ()),
                     "kernel_seconds": c.get("kernel_seconds"),
                     "chain_seconds": c.get("chain_seconds"),
                     "boundary_bytes": c.get("boundary_bytes")}
                    for v in present for c in [uplan.kernel_choices[v]]]
            prefixes = {"chunk": ("chunk_",), "cache": ("cache_",),
                        "precision": ("trail_",), "kernel": ("kernel_",),
                        "spill": ("spill_", "cache_"),
                        "placement": ()}.get(kind, ())
            alternatives = [
                c for c in uplan.scored_candidates
                if c.get("entry") in ("sequential", "chain_dp_product")
                or (prefixes
                    and str(c.get("entry", "")).startswith(prefixes))]
            predicted = {
                "predicted_seconds": float(uplan.joint_seconds),
                "sequential_seconds": float(uplan.sequential_seconds),
                "seconds_saved": float(uplan.savings_seconds),
            }
            if kind == "spill":
                reload_s = sum(
                    float(p.get("reload_seconds") or 0.0)
                    for v, p in uplan.spill_predictions.items()
                    if v in present)
                if reload_s:
                    predicted["reload_seconds"] = reload_s
            ledger.record_decision(
                kind=kind, rule="UnifiedPlannerRule",
                vertices=[v.id for v in present],
                labels=[_label(graph, v) for v in present],
                chosen=chosen, alternatives=alternatives,
                predicted=predicted)
        except Exception:
            logger.debug("unified decision not recorded", exc_info=True)


class _ClearPlannedChunkRule(Rule):
    """In place of `UnifiedPlannerRule` where the constructor opts out
    (`:593-605`): clears a previous plan's chunk decision at the point
    the unified rule would have re-decided it. The graph is untouched."""

    def apply(self, plan: Plan) -> Plan:
        from .env import set_planned_chunk_size

        set_planned_chunk_size(None)
        return plan


def _current_layout():
    from ..parallel.mesh import layout_of

    return layout_of(None)


class ShardingPlannerRule(Rule):
    """Per-stage placement as an optimizer decision (`:608-771`):
    `analysis/planner.py::plan_sharding` chooses and prices, this rule
    enforces.

    Runs after fusion and megafusion, so the decision sees the programs
    that will run. A strict no-op (the plan as it was, bit for bit) with
    ``ExecutionConfig.sharding_planner`` off, where an enforced unified
    plan owns the placement, on one card, on a plan with no device
    dataset, where the plan does not beat the default placement's priced
    boundary bytes, and on a planner failure (logged). Enforcing a
    winning plan:

      - a fused program (`FusedChainOperator`, `FusedBatchTransformer`)
        whose chosen output placement differs from the default is
        replaced by a tagged copy carrying ``planned_out_spec``, so its
        output lands in the chosen tile (`nodes/util/fusion.py`);
      - a plan-input `DatasetOperator` is re-seeded with its dataset
        moved to the chosen placement by `Dataset.reshard` (the
        identity short-circuit moves nothing where it is unchanged).

    Operators are copied, never mutated: an instance shared between
    pipelines must not carry one plan's placement into another. Each
    enforced plan leaves one ``placement`` ledger record and counts
    ``planner.plans_enforced`` and ``planner.boundary_bytes_saved``."""

    def apply(self, plan: Plan) -> Plan:
        from .env import execution_config

        cfg = execution_config()
        if not cfg.sharding_planner:
            return plan
        if cfg.unified_planner and unified_enforced(plan[0]):
            return plan
        layout = _current_layout()
        if layout.size <= 1:
            return plan
        graph, prefixes = plan
        if not _has_device_dataset(graph):
            return plan
        with span("sharding_planner", cat="phase", devices=layout.size):
            try:
                from ..analysis.planner import plan_sharding

                splan = plan_sharding(graph, _specs_of(graph), mesh=layout,
                                      hbm_budget_bytes=cfg.hbm_budget_bytes)
            except Exception:
                logger.debug("sharding planner failed; plan unchanged",
                             exc_info=True)
                return plan
            if splan is None or not splan.improved:
                return plan
            _BOUNDARY_SAVED.inc(splan.savings_bytes)
            _PLANS_ENFORCED.inc()
            logger.info(
                "ShardingPlannerRule: enforcing plan, boundary bytes "
                "%d -> %d (%d saved)", int(splan.default_cost_bytes),
                int(splan.planned_cost_bytes), splan.savings_bytes)
            self._record_decision(graph, splan)
            graph = self._enforce(graph, splan)
        return graph, prefixes

    @staticmethod
    def _record_decision(graph: Graph, splan) -> None:
        """One ledger record a placement plan (`:687-727`): the changed
        stages, their families, the scored candidates as alternatives
        and the predicted boundary bytes. Never raises."""
        try:
            from ..analysis.propagate import _label

            changed = splan.changed_vertices()
            chosen_cost = float(splan.planned_cost_bytes)
            alternatives = [c for c in splan.scored_candidates
                            if c.get("cost_bytes") != chosen_cost]
            if not alternatives:
                alternatives = [{"entry": "default",
                                 "cost_bytes":
                                 float(splan.default_cost_bytes)}]
            ledger.record_decision(
                kind="placement",
                rule="ShardingPlannerRule",
                vertices=[getattr(v, "id", -1) for v in changed],
                labels=[_label(graph, v) for v in changed],
                chosen={"entry": "planned_assignment",
                        "families": {str(v): splan.families.get(v)
                                     for v in changed},
                        "cost_bytes": chosen_cost},
                alternatives=alternatives,
                predicted={"boundary_bytes": chosen_cost,
                           "boundary_bytes_saved":
                           int(splan.savings_bytes)})
        except Exception:
            logger.debug("placement decision not recorded", exc_info=True)

    @staticmethod
    def _enforce(graph: Graph, splan, mark_unified: bool = False) -> Graph:
        """Tagged copies of the changed fused programs and re-seeded
        plan inputs (`:740-771`)."""
        for vid in splan.changed_vertices():
            if vid not in getattr(graph, "operators", {}):
                continue
            op = graph.get_operator(vid)
            spec = splan.spec_for(vid)
            if spec is None:
                continue
            if _fused_program(op):
                tags = dict(planned_out_spec=spec)
                if mark_unified:
                    tags["planned_by_unified"] = True
                graph = graph.set_operator(vid, op.tagged_copy(**tags))
            elif isinstance(op, DatasetOperator) \
                    and hasattr(op.dataset, "reshard"):
                try:
                    reseeded = op.dataset.reshard(spec)
                except Exception:
                    continue  # this input keeps its default placement
                graph = graph.set_operator(
                    vid, DatasetOperator(reseeded, name=op.name))
        return graph


class PrecisionPlannerRule(Rule):
    """Per-stage storage dtypes of each fused program as an optimizer
    decision (`analysis/precision.py` decides; `:774-945`).

    A strict no-op with ``ExecutionConfig.precision_planner`` off, where
    an enforced unified plan owns the axis, on plans with no fused
    program or no device dataset, where no trail saves
    ``precision_min_savings_bytes``, and on a planner failure (logged,
    plan unchanged). Otherwise each fused program whose trail wins is
    replaced by a tagged copy carrying ``planned_precision``, plus
    ``planned_matmul_precision="bfloat16"`` where every stage is
    tolerant; the program's output dtype never changes."""

    def apply(self, plan: Plan) -> Plan:
        from .env import execution_config

        cfg = execution_config()
        if not cfg.precision_planner:
            return plan
        if cfg.unified_planner and unified_enforced(plan[0]):
            return plan
        graph, prefixes = plan
        targets = [vid for vid in sorted(graph.operators, key=lambda n: n.id)
                   if _fused_program(graph.get_operator(vid))]
        if not targets or not _has_device_dataset(graph):
            return plan
        with span("precision_planner", cat="phase", programs=len(targets)):
            try:
                from ..analysis.precision import plan_stage_precision

                specs = _specs_of(graph)
                total_saved = 0
                tagged = 0
                for vid in targets:
                    op = graph.get_operator(vid)
                    if op.planned_precision is not None:
                        continue  # planned already (a re-optimization)
                    decided = plan_stage_precision(graph, vid, op, specs)
                    if decided is None:
                        continue
                    storage, saved, menu = decided
                    if saved < cfg.precision_min_savings_bytes:
                        continue
                    tags = dict(planned_precision=storage)
                    if self._all_compute_tolerant(graph, vid, op):
                        tags["planned_matmul_precision"] = "bfloat16"
                    graph = graph.set_operator(vid, op.tagged_copy(**tags))
                    self._record_decision(graph, vid, op, storage, saved,
                                          menu)
                    total_saved += saved
                    tagged += 1
            except Exception:
                logger.debug("precision planner failed; plan unchanged",
                             exc_info=True)
                return plan
            if not tagged:
                return plan
            _BYTES_HALVED.inc(total_saved)
            _PRECISION_ENFORCED.inc(tagged)
            logger.info(
                "PrecisionPlannerRule: enforcing bf16 storage on %d "
                "program(s), %d boundary bytes saved", tagged, total_saved)
        return graph, prefixes

    @staticmethod
    def _record_decision(graph: Graph, vid, op, storage, saved: int,
                         menu=None, rule: str = "PrecisionPlannerRule"
                         ) -> None:
        """One ledger record per tagged program: the storage trail, the
        all-f32 reference and the runs the chain DP rejected as the
        alternatives, the predicted casts (`:882-934`). Never raises."""
        try:
            casts = sum(1 for s in storage if s is not None)
            alternatives = [{"entry": "f32_reference", "bytes_saved": 0,
                             "cost_bytes_extra": int(saved)}]
            for cand in menu or []:
                if cand.get("kept"):
                    continue
                alternatives.append({
                    "entry": cand["entry"],
                    "bytes_saved": int(cand.get("bytes_saved", 0)),
                    "cast_penalty_bytes": int(
                        cand.get("cast_penalty_bytes", 0)),
                    "rejected": cand.get("dropped", "below_cast_penalty"),
                })
            ledger.record_decision(
                kind="precision", rule=rule,
                vertices=[getattr(vid, "id", -1)], labels=[op.label],
                chosen={"entry": "bf16_storage", "storage": list(storage),
                        "bytes_saved": int(saved), "cost_bytes_extra": 0},
                alternatives=alternatives,
                predicted={"policy_bytes_saved": int(saved),
                           "casts_baked": casts})
        except Exception:
            logger.debug("precision decision not recorded", exc_info=True)

    @staticmethod
    def _all_compute_tolerant(graph: Graph, vid, op) -> bool:
        from ..analysis.precision import TOLERANT, stage_tolerance

        stage_specs = getattr(op, "stage_specs", None)
        if stage_specs is None:
            stage_specs = list(getattr(op, "stages", []))
        return bool(stage_specs) and all(
            stage_tolerance(s, graph, vid) == TOLERANT
            for s in stage_specs)


class Optimizer(RuleExecutor):
    pass


class DefaultOptimizer(Optimizer):
    """JAX's constructor and batch order (`:952-1023`): ``state``
    (saved-state reuse, dead-branch removal), ``cse`` to fixpoint,
    ``fuse`` (`NodeFusionRule`, then `MegafusionRule` where
    ``fuse_apply`` and ``megafuse``), ``unified``, ``place``,
    ``precision`` and ``node-opt``. Each planner flag off builds the
    plan without it; ``unified_planner=False`` still clears a stale
    chunk decision. Each planner rule also reads its
    `ExecutionConfig` switch when it runs."""

    def __init__(self, samples_per_shard: int = 3, fuse: bool = True,
                 fusion_microbatch: int = 2048, fuse_apply: bool = True,
                 megafuse: bool = True, sharding_planner: bool = True,
                 precision_planner: bool = True,
                 unified_planner: bool = True):
        from .fusion_rule import MegafusionRule, NodeFusionRule

        self._batches = [
            Batch("state", [ExtractSaveablePrefixes(), SavedStateLoadRule(),
                            UnusedBranchRemovalRule()]),
            Batch("cse", [EquivalentNodeMergeRule()], max_iterations=10),
        ]
        if fuse:
            rules: List[Rule] = [
                NodeFusionRule(fusion_microbatch, fuse_apply=fuse_apply)]
            if fuse_apply and megafuse:
                rules.append(MegafusionRule(fusion_microbatch))
            self._batches.append(Batch("fuse", rules))
        self._batches.append(Batch("unified", [
            UnifiedPlannerRule() if unified_planner
            else _ClearPlannedChunkRule()]))
        if sharding_planner:
            self._batches.append(Batch("place", [ShardingPlannerRule()]))
        if precision_planner:
            self._batches.append(Batch("precision",
                                       [PrecisionPlannerRule()]))
        self._batches.append(Batch("node-opt", [
            NodeOptimizationRule(samples_per_shard)]))

    @property
    def batches(self) -> List[Batch]:
        return self._batches


class AutoCachingOptimizer(Optimizer):
    """DefaultOptimizer plus profile-guided automatic caching
    (DefaultOptimizer.scala:8-31 with AutoCacheRule appended)."""

    def __init__(self, strategy: str = "greedy", mem_budget_bytes: int = None):
        from .autocache import AutoCacheRule

        self._batches = DefaultOptimizer().batches + [
            Batch("auto-cache", [AutoCacheRule(strategy, mem_budget_bytes)])]

    @property
    def batches(self) -> List[Batch]:
        return self._batches
