"""The stage-fusion rule.

Counterpart of `keystone_tpu/workflow/fusion_rule.py:102-300, 601-805`.
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
from any member, so the result does not depend on node-id order. The JAX
package's `MegafusionRule` has no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence

from .analysis import children
from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)
from .graph import Graph, NodeId
from .operators import (
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    GatherTransformerOperator,
    Operator,
)
from .optimizer import Plan, Rule


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

    def __init__(self, stage_specs: Sequence, microbatch: int = 2048):
        self.stage_specs = list(stage_specs)
        self.microbatch = microbatch

    @property
    def n_fits(self) -> int:
        return sum(1 for s in self.stage_specs if isinstance(s, _FitSlot))

    @property
    def estimator_positions(self) -> tuple:
        """Dependency indices that consume estimator outputs (KP003)."""
        return tuple(range(self.n_fits))

    @property
    def label(self) -> str:
        return "Fused[" + " >> ".join(
            repr(s) if isinstance(s, _FitSlot) else s.label
            for s in self.stage_specs) + "]"

    def materialize(self, fitted: Sequence):
        """Resolve the `_FitSlot`s against ``fitted`` (one transformer
        per estimator dependency, in order) and build the runnable
        transformer. Shared by force-time execution and `Pipeline.fit`."""
        from ..nodes.util.fusion import FusedBatchTransformer
        from .pipeline import TransformerChain

        stages = [fitted[s.index] if isinstance(s, _FitSlot) else s
                  for s in self.stage_specs]
        if all(getattr(s, "fusable", False) for s in stages):
            return FusedBatchTransformer(stages, microbatch=self.microbatch)
        return TransformerChain(stages)

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
        return DatasetExpression(lambda: make().batch_transform([data.get]))


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
