"""The stage-fusion and megafusion rules.

Counterpart of `keystone_tpu/workflow/fusion_rule.py:102-600, 601-805`.
`NodeFusionRule` finds maximal linear chains of adjacent nodes and
replaces each chain with one operator:

  - transformer nodes that declare ``fusable = True`` fuse into one
    `FusedBatchTransformer` (`nodes/util/fusion.py`), which runs the
    chain over microbatches of rows. It tags its own chain-kernel run,
    the choice the JAX package's unified planner makes (the port has no
    such planner); a stage that is itself a fused featurizer is one
    opaque stage, with its own tag inside;
  - chains extend through estimator apply boundaries: a `DelegatingOperator` whose estimator declares
    ``fusable_fit = True`` (scalers, least-squares mappers) joins the
    chain as a `_FitSlot`, and the chain becomes a `FusedChainOperator`
    whose extra dependencies are the estimator expressions; at force
    time the fitted transformers fill the slots;
  - ``Pipeline.gather`` diamonds (N fusable
    branches over one source, zipped and read by a `VectorCombiner`)
    collapse into one `_GatherConcatStage` (`_fuse_gathers`).

A node with two children ends a chain (fusing across a fan-out would
repeat work for one consumer), and discovery walks up to the chain head
from any member, so the result does not depend on node-id order.

`MegafusionRule` (`:374-535`) runs after it and merges the fused members
that remain on a fan-out-free chain (fused transformers, fused chains
with their fit slots re-indexed, `Cacher`s absorbed) into one
`MegafusedPlanOperator`, whose forced form is a
`MegafusedBatchTransformer`: the apply path's chunk loop as one CUDA
graph replay. Every member's saveable prefix is dropped.
`megafusion_blockers` (`:538-600`) says what stops a plan from
collapsing. The JAX package's ``scan_live_nbytes`` and its KP401
diagnostic need the spec analysis, which the port does not have yet
(ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

from ..telemetry import ledger
from .analysis import children
from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    StreamingDatasetExpression,
    TransformerExpression,
)
from .graph import Graph, NodeId
from .operators import (
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    GatherTransformerOperator,
    Operator,
    _overlap_enabled,
    _streamed_batch,
    is_stream_origin,
)
from .optimizer import Plan, Rule


def _record_fusion_decision(kind: str, rule: str, chain, labels,
                            chosen_entry: str, programs_before: int) -> None:
    """One ledger record per enforced fusion rewrite (JAX's
    `fusion_rule.py:57-99`): the chain's vertices and labels, the program
    shape chosen, the per-stage dispatch it beat, and the programs an
    apply saves. JAX's roofline ``predicted_seconds`` waits for the
    analysis tiers (ROADMAP queue 1, item 8)."""
    ledger.record_decision(
        kind=kind,
        rule=rule,
        vertices=[n.id for n in chain],
        labels=list(labels),
        chosen={"entry": chosen_entry, "programs": 1,
                "members": len(chain)},
        alternatives=[{"entry": "per_stage_dispatch",
                       "programs": programs_before,
                       "cost_programs": programs_before}],
        predicted={"programs_per_apply": 1,
                   "programs_eliminated": max(0, programs_before - 1),
                   "cold_compiles_max": 1},
    )


#: guards the fused chains' kept builds across the scheduler's workers
_MATERIALIZE_LOCK = threading.RLock()


class _FitSlot:
    """Placeholder in a fused chain's stage list: 'the transformer fitted
    by estimator dependency ``index``' (resolved at force time)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self) -> str:
        return f"fit:{self.index}"


class FusedChainOperator(Operator):
    """A fused linear chain that crosses estimator apply boundaries.

    Dependencies: ``(est_0, ..., est_{k-1}, data)``, the estimator
    expressions whose fitted transformers fill the chain's `_FitSlot`s,
    then the data input. Forcing the output forces the fits (fit-once
    holds: the shared TransformerExpressions memoize) and runs the fitted
    stage list as one `FusedBatchTransformer`; a fit that yields a
    transformer that is not fusable makes it a `TransformerChain`: the
    same values, stage by stage."""

    #: the scheduler keeps a chunk stream into it lazy
    may_consume_chunks = True

    #: display prefix, overridden by `MegafusedPlanOperator`
    _label_prefix = "Fused"

    def __init__(self, stage_specs: Sequence, microbatch: int = 2048):
        self.stage_specs = list(stage_specs)
        self.microbatch = microbatch

    def _fused_cls(self):
        from ..nodes.util.fusion import FusedBatchTransformer

        return FusedBatchTransformer

    @property
    def n_fits(self) -> int:
        return sum(1 for s in self.stage_specs if isinstance(s, _FitSlot))

    @property
    def estimator_positions(self) -> tuple:
        """Dependency indices that consume estimator outputs (KP003)."""
        return tuple(range(self.n_fits))

    @property
    def label(self) -> str:
        return self._label_prefix + "[" + " >> ".join(
            repr(s) if isinstance(s, _FitSlot) else s.label
            for s in self.stage_specs) + "]"

    def materialize(self, fitted: Sequence):
        """Resolve the `_FitSlot`s against ``fitted`` (one transformer
        per estimator dependency, in order) and build the runnable
        transformer. Shared by force-time execution, warm-ups and
        `Pipeline.fit`. The last build is kept and returned again for the
        same fitted transformers, so its launch plans and graphs (the
        JAX package's structure-keyed program caches) serve every apply
        and the warm-up's work is the force's."""
        from .pipeline import TransformerChain

        fitted = tuple(fitted)
        with _MATERIALIZE_LOCK:
            hit = self.__dict__.get("_materialized")
            if hit is not None and len(hit[0]) == len(fitted) and all(
                    a is b for a, b in zip(hit[0], fitted)):
                return hit[1]
            stages = [fitted[s.index] if isinstance(s, _FitSlot) else s
                      for s in self.stage_specs]
            if all(getattr(s, "fusable", False) for s in stages):
                built = self._fused_cls()(stages, microbatch=self.microbatch)
            else:
                built = TransformerChain(stages)
            self._materialized = (fitted, built)
            return built

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_materialized", None)
        return state

    def execute(self, deps: Sequence[Expression]) -> Expression:
        deps = list(deps)
        if len(deps) != self.n_fits + 1:
            raise ValueError(
                f"{self.label} expects {self.n_fits} estimator "
                f"dependency(ies) plus one data dependency, got {len(deps)}")
        t_exprs, data = deps[:-1], deps[-1]
        for t in t_exprs:
            if not isinstance(t, TransformerExpression):
                raise ValueError(
                    f"{self.label}: estimator dependency did not produce a "
                    "transformer expression")

        def make():
            # the fits are forced here, inside the chain's own force
            return self.materialize([t.get for t in t_exprs])

        if isinstance(data, DatumExpression):
            return DatumExpression(
                lambda: make().single_transform([data.get]))
        if _overlap_enabled():
            return StreamingDatasetExpression(
                lambda: _streamed_batch(make(), data))
        return DatasetExpression(lambda: make().batch_transform([data.get]))


class MegafusedPlanOperator(FusedChainOperator):
    """A whole apply path as one chain (`keystone_tpu/workflow/
    fusion_rule.py:301-321`): forcing it materializes a
    `MegafusedBatchTransformer`, whose chunk loop is one CUDA graph
    replay, with the fitted transformers in their slots."""

    _label_prefix = "Megafused"

    def _fused_cls(self):
        from ..nodes.util.fusion import MegafusedBatchTransformer

        return MegafusedBatchTransformer


class MegafusionRule(Rule):
    """Collapse a fan-out-free chain of fused members into one
    `MegafusedPlanOperator` (`keystone_tpu/workflow/fusion_rule.py:
    374-535`).

    Runs after `NodeFusionRule`. Members consume each other as their one
    data input: fused chains (their fit slots re-indexed into the merged
    operator's estimator dependencies), fusable single-input
    transformers, and `Cacher`s (absorbed: inside one graph there is no
    intermediate to keep). A fan-out, a stage that is not fusable or a
    stream-producing stage ends the chain. A merge needs two members
    that run work; a lone fused chain on the plan's input is promoted
    too, being the whole apply path. `ExecutionConfig.megafusion` is read
    when the rule runs; off, the plan is `NodeFusionRule`'s.

    The merged chain's trip is the widest microbatch among the rule's
    and its nested fused members', so each nested chain launches its
    kernels at most once a trip, as it does on its own."""

    def __init__(self, microbatch: int = 2048):
        self.microbatch = microbatch

    @staticmethod
    def _member_kind(graph: Graph, node: NodeId):
        """'chain' (carries fit slots), 'stage' (fusable), 'cache' (an
        identity the chain absorbs), or None (ends the chain)."""
        from ..nodes.util.basic import Cacher
        from .operators import TransformerOperator

        op = graph.get_operator(node)
        deps = graph.get_dependencies(node)
        if isinstance(op, FusedChainOperator):
            return "chain"
        if isinstance(op, Cacher) and len(deps) == 1:
            return "cache"
        if isinstance(op, TransformerOperator) \
                and getattr(op, "fusable", False) and len(deps) == 1:
            return "stage"
        return None

    @staticmethod
    def _data_dep(graph: Graph, node: NodeId):
        deps = graph.get_dependencies(node)
        if isinstance(graph.get_operator(node), FusedChainOperator):
            return deps[-1]
        return deps[0]

    @staticmethod
    def _is_plan_input(graph: Graph, dep) -> bool:
        """Whether ``dep`` is the plan's own input (an unbound source,
        bound data or saved state), not a node mid-plan."""
        from .graph import SourceId
        from .operators import DatasetOperator, DatumOperator

        if isinstance(dep, SourceId):
            return True
        if not isinstance(dep, NodeId):
            return False
        return isinstance(graph.get_operator(dep),
                          (DatasetOperator, DatumOperator, ExpressionOperator))

    def apply(self, plan: Plan) -> Plan:
        from ..nodes.util.fusion import FusedBatchTransformer
        from .env import execution_config

        if not execution_config().megafusion:
            return plan
        graph, prefixes = plan
        visited: set = set()
        chains: List[List[NodeId]] = []
        for node in sorted(graph.operators, key=lambda n: n.id):
            if node in visited or self._member_kind(graph, node) is None:
                continue
            head = node
            while True:
                dep = self._data_dep(graph, head)
                if (isinstance(dep, NodeId)
                        and self._member_kind(graph, dep) is not None
                        and len(children(graph, dep)) == 1):
                    head = dep
                else:
                    break
            chain = [head]
            cur = head
            while True:
                kids = children(graph, cur)
                if len(kids) != 1:
                    break
                (kid,) = kids
                if (isinstance(kid, NodeId)
                        and self._member_kind(graph, kid) is not None
                        and self._data_dep(graph, kid) == cur):
                    chain.append(kid)
                    cur = kid
                else:
                    break
            visited.update(chain)
            kinds = [self._member_kind(graph, n) for n in chain]
            programs = sum(1 for k in kinds if k != "cache")
            whole_plan_single = (
                len(chain) == 1 and kinds[0] == "chain"
                and self._is_plan_input(graph,
                                        self._data_dep(graph, chain[0])))
            if (len(chain) >= 2 and programs >= 2) or whole_plan_single:
                chains.append(chain)

        for chain in chains:
            if any(n not in graph.operators for n in chain):
                continue
            _record_fusion_decision(
                "megafusion", type(self).__name__, chain,
                [graph.get_operator(n).label for n in chain],
                "megafused_scan_program",
                max(1, sum(1 for n in chain
                           if self._member_kind(graph, n) != "cache")))
            head_data_dep = self._data_dep(graph, chain[0])
            est_deps: List = []
            stage_specs: List = []
            for n in chain:
                kind = self._member_kind(graph, n)
                op = graph.get_operator(n)
                if kind == "chain":
                    base = len(est_deps)
                    est_deps.extend(graph.get_dependencies(n)[:-1])
                    for s in op.stage_specs:
                        stage_specs.append(
                            _FitSlot(base + s.index)
                            if isinstance(s, _FitSlot) else s)
                elif kind == "stage":
                    stage_specs.append(op)
            trip = max([self.microbatch] + [
                s.microbatch for s in stage_specs
                if isinstance(s, FusedBatchTransformer)])
            fused = MegafusedPlanOperator(stage_specs, microbatch=trip)
            graph = graph.set_operator(chain[0], fused)
            graph = graph.replace_dependency(chain[-1], chain[0])
            graph = graph.set_dependencies(
                chain[0], tuple(est_deps) + (head_data_dep,))
            for n in reversed(chain[1:]):
                graph = graph.set_dependencies(n, ())
                graph = graph.remove_node(n)
            # every member's prefix goes, the head's too: the head now
            # computes the whole chain, and saving that under the old
            # head's prefix (an absorbed Cacher's) would hand a later
            # pipeline the wrong value
            for n in chain:
                prefixes.pop(n, None)
        return graph, prefixes


def megafusion_blockers(graph: Graph) -> List[Tuple[NodeId, str, str]]:
    """Why a plan cannot collapse to one graph (`keystone_tpu/workflow/
    fusion_rule.py:538-600`): ``(vertex, label, reason)`` for each
    blocker next to an otherwise fusable member of the node-fused
    plan."""
    from .operators import TransformerOperator

    # an analysis re-run on a throwaway graph: no executor enforces these
    # rewrites, so they stay out of the run's ledger
    with ledger.suppressed():
        fused_graph = NodeFusionRule().apply((graph, {}))[0]
    kinds = {n: MegafusionRule._member_kind(fused_graph, n)
             for n in fused_graph.operators}

    def neighbors(node):
        out = [d for d in fused_graph.get_dependencies(node)
               if isinstance(d, NodeId)]
        out.extend(u for u in children(fused_graph, node)
                   if isinstance(u, NodeId))
        return out

    blockers: List[Tuple[NodeId, str, str]] = []
    for node in sorted(fused_graph.operators, key=lambda n: n.id):
        op = fused_graph.get_operator(node)
        if kinds.get(node) is not None:
            kids = [k for k in children(fused_graph, node)
                    if isinstance(k, NodeId) and kinds.get(k) is not None]
            all_kids = children(fused_graph, node)
            if len(all_kids) > 1 and kids:
                blockers.append((node, op.label, (
                    f"fan-out ({len(all_kids)} consumers) ends the "
                    "megafused chain here; each branch runs on its own")))
            continue
        if not any(kinds.get(nb) is not None for nb in neighbors(node)):
            continue
        if is_stream_origin(op):
            blockers.append((node, op.label, (
                "stream-producing host stage stays on the overlapped "
                "host-staging path; one graph can only start after it")))
        elif isinstance(op, DelegatingOperator):
            deps = fused_graph.get_dependencies(node)
            if deps and NodeFusionRule._est_fusable(fused_graph, deps[0]):
                continue
            blockers.append((node, op.label, (
                "estimator apply boundary is not provably fusable (the "
                "estimator does not declare fusable_fit)")))
        elif isinstance(op, TransformerOperator) \
                and not getattr(op, "fusable", False):
            blockers.append((node, op.label, (
                "host-code stage (fusable=False) cannot enter a graph; "
                "the chain splits around it")))
    return blockers


class NodeFusionRule(Rule):
    #: rows a fused chain runs at a time (`FusedBatchTransformer`)
    microbatch = 2048

    @staticmethod
    def _est_fusable(graph: Graph, dep) -> bool:
        """Will this delegate's estimator dependency produce a fusable
        transformer? Provable for estimators that declare
        ``fusable_fit`` and for already-forced saved state."""
        if not isinstance(dep, NodeId):
            return False
        op = graph.get_operator(dep)
        if isinstance(op, EstimatorOperator):
            return bool(getattr(op, "fusable_fit", False))
        if isinstance(op, ExpressionOperator):
            e = op.expression
            return (isinstance(e, TransformerExpression) and e.is_forced
                    and bool(getattr(e.get, "fusable", False)))
        return False

    def _fusable(self, graph: Graph, node: NodeId) -> bool:
        op = graph.get_operator(node)
        deps = graph.get_dependencies(node)
        if getattr(op, "fusable", False) and len(deps) == 1:
            return True
        return (isinstance(op, DelegatingOperator)
                and len(deps) == 2
                and self._est_fusable(graph, deps[0]))

    @staticmethod
    def _data_dep(graph: Graph, node: NodeId):
        """The chain-forming (data) dependency of a fusable node."""
        deps = graph.get_dependencies(node)
        if isinstance(graph.get_operator(node), DelegatingOperator):
            return deps[1]
        return deps[0]

    def _fuse_gathers(self, plan: Plan) -> Plan:
        """Collapse a ``Pipeline.gather`` diamond, N single-dep fusable
        branches over one source zipped by a GatherTransformerOperator
        whose sole consumer is a VectorCombiner, into one
        `FusedBatchTransformer` over a `_GatherConcatStage`."""
        from ..nodes.util.basic import VectorCombiner
        from ..nodes.util.fusion import FusedBatchTransformer, _GatherConcatStage

        graph, prefixes = plan
        gathers = [n for n in sorted(graph.operators, key=lambda n: n.id)
                   if isinstance(graph.get_operator(n),
                                 GatherTransformerOperator)]
        for g in gathers:
            if g not in graph.operators:
                continue
            deps = graph.get_dependencies(g)
            if not deps or not all(isinstance(d, NodeId) for d in deps):
                continue
            srcs = set()
            ok = True
            for b in deps:
                op = graph.get_operator(b)
                bdeps = graph.get_dependencies(b)
                if not (getattr(op, "fusable", False) and len(bdeps) == 1
                        and set(children(graph, b)) == {g}):
                    ok = False
                    break
                srcs.add(bdeps[0])
            if not ok or len(srcs) != 1:
                continue
            kids = children(graph, g)
            if len(kids) != 1:
                continue
            (kid,) = kids
            if not isinstance(kid, NodeId) or not isinstance(
                    graph.get_operator(kid), VectorCombiner):
                continue
            if graph.get_dependencies(kid) != (g,):
                continue
            (src,) = srcs
            _record_fusion_decision(
                "fusion", type(self).__name__, list(deps) + [g, kid],
                [graph.get_operator(b).label for b in deps]
                + [graph.get_operator(g).label,
                   graph.get_operator(kid).label],
                "gather_concat_program", len(deps) + 1)
            stage = _GatherConcatStage([graph.get_operator(b) for b in deps])
            graph = graph.set_operator(kid, FusedBatchTransformer(
                [stage], microbatch=self.microbatch))
            graph = graph.set_dependencies(kid, (src,))
            graph = graph.remove_node(g)
            prefixes.pop(g, None)
            for b in dict.fromkeys(deps):
                graph = graph.remove_node(b)
                prefixes.pop(b, None)
        return graph, prefixes

    def apply(self, plan: Plan) -> Plan:
        # gather diamonds need the linear pass first (each branch collapses
        # to one node over the shared source), and another linear pass
        # after, so the collapsed combiner chains with its downstream
        # neighbours
        plan = self._fuse_linear(plan)
        plan = self._fuse_gathers(plan)
        return self._fuse_linear(plan)

    def _fuse_linear(self, plan: Plan) -> Plan:
        from ..nodes.util.fusion import FusedBatchTransformer

        graph, prefixes = plan
        visited: set = set()
        chains: List[List[NodeId]] = []
        for node in sorted(graph.operators, key=lambda n: n.id):
            if node in visited or not self._fusable(graph, node):
                continue
            # walk up to the chain head
            head = node
            while True:
                dep = self._data_dep(graph, head)
                if (isinstance(dep, NodeId) and self._fusable(graph, dep)
                        and len(children(graph, dep)) == 1):
                    head = dep
                else:
                    break
            # walk down collecting the chain; a fan-out ends it
            chain = [head]
            cur = head
            while True:
                kids = children(graph, cur)
                if len(kids) != 1:
                    break
                (kid,) = kids
                # the child must consume cur as its data input: a
                # delegate whose estimator feeds from cur is a fit
                # boundary, not a chain link
                if (isinstance(kid, NodeId) and self._fusable(graph, kid)
                        and self._data_dep(graph, kid) == cur):
                    chain.append(kid)
                    cur = kid
                else:
                    break
            visited.update(chain)
            if len(chain) >= 2:
                chains.append(chain)

        for chain in chains:
            if any(n not in graph.operators for n in chain):
                continue  # already rewritten by an overlapping chain
            _record_fusion_decision(
                "fusion", type(self).__name__, chain,
                [graph.get_operator(n).label for n in chain],
                "fused_chain_program", len(chain))
            head_data_dep = self._data_dep(graph, chain[0])
            est_deps: List = []
            stage_specs: List = []
            for n in chain:
                op = graph.get_operator(n)
                if isinstance(op, DelegatingOperator):
                    stage_specs.append(_FitSlot(len(est_deps)))
                    est_deps.append(graph.get_dependencies(n)[0])
                else:
                    stage_specs.append(op)
            if est_deps:
                fused: Operator = FusedChainOperator(
                    stage_specs, microbatch=self.microbatch)
                new_deps = tuple(est_deps) + (head_data_dep,)
            else:
                fused = FusedBatchTransformer(
                    stage_specs, microbatch=self.microbatch)
                new_deps = (head_data_dep,)
            graph = graph.set_operator(chain[0], fused)
            # rewire users of the tail to the head, then drop the rest;
            # the rewire may make the head depend on itself, so its true
            # dependencies are set after it
            graph = graph.replace_dependency(chain[-1], chain[0])
            graph = graph.set_dependencies(chain[0], new_deps)
            for n in reversed(chain[1:]):
                graph = graph.set_dependencies(n, ())
                graph = graph.remove_node(n)
            for n in chain[1:]:
                prefixes.pop(n, None)
        return graph, prefixes
