"""Rule engine and the standard optimization rules.

Counterpart of `keystone_tpu/workflow/optimizer.py:41-262, 948-1043`
(reference workflow/{Rule,RuleExecutor,DefaultOptimizer}.scala and the
rules):
  - ExtractSaveablePrefixes + SavedStateLoadRule: fitted-state reuse
    (ExtractSaveablePrefixes.scala:9-22, SavedStateLoadRule.scala:7-20)
  - UnusedBranchRemovalRule: dead-branch elimination
    (UnusedBranchRemovalRule.scala:7-24)
  - EquivalentNodeMergeRule: common-subexpression elimination
    (EquivalentNodeMergeRule.scala:13-48)
  - NodeOptimizationRule: sample-driven node-level implementation choice
    (NodeOptimizationRule.scala:14-198)
  - NodeFusionRule and MegafusionRule (`fusion_rule.py`) and
    AutoCacheRule (`autocache.py`).

The JAX `DefaultOptimizer`'s ``unified``, ``place`` and ``precision``
batches price TPU programs, meshes and XLA compiles; they are re-derived
for the card with multi-GPU (ROADMAP queue 1, item 10), not copied.

A *plan* is ``(Graph, dict[NodeId, Prefix])``, the prefix map holding
only the saveable nodes' structural prefixes.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..telemetry.metrics import counter
from ..telemetry.spans import span
from .analysis import ancestors, linearize
from .env import PipelineEnv, Prefix, compute_prefix
from .graph import Graph, NodeId
from .operators import DatasetOperator, ExpressionOperator

_PREFIX_REUSE = counter("executor.prefix_reuse")

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


class Optimizer(RuleExecutor):
    pass


class DefaultOptimizer(Optimizer):
    """The batches of DefaultOptimizer.scala:8-31 (saved-state reuse and
    dead-branch removal once, CSE to fixpoint, node-level optimization
    once) with the fusion pass between CSE and node-level optimization,
    as the JAX package orders them with its planners off
    (`keystone_tpu/workflow/optimizer.py:966-988`). ``megafuse`` appends
    `MegafusionRule` to the ``fuse`` batch, after `NodeFusionRule`; the
    rule also reads `ExecutionConfig.megafusion` when it runs."""

    def __init__(self, megafuse: bool = True):
        from .fusion_rule import MegafusionRule, NodeFusionRule

        fuse: List[Rule] = [NodeFusionRule()]
        if megafuse:
            fuse.append(MegafusionRule(NodeFusionRule.microbatch))
        self._batches = [
            Batch("state", [ExtractSaveablePrefixes(), SavedStateLoadRule(),
                            UnusedBranchRemovalRule()]),
            Batch("cse", [EquivalentNodeMergeRule()], max_iterations=10),
            Batch("fuse", fuse),
            Batch("node-opt", [NodeOptimizationRule()]),
        ]

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
