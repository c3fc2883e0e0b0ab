"""Structural checks and abstract spec propagation over a lowered Graph.

Counterpart of `keystone_tpu/analysis/propagate.py:1-217`. Two tiers:

  - `structural_pass(graph)`: pure topology lints, O(V+E) and data free:
    cycles (KP001), arity (KP002), fit-before-use (KP003), inverted
    delegate wiring (KP004) and dangling sources (KP005). `GraphExecutor`
    runs it before the first force, so a malformed plan fails before any
    data moves.
  - `spec_pass(graph, source_specs, seeds=...)`: walks the graph in
    topological order calling each operator's ``abstract_eval`` hook (by
    default its single-item path on meta tensors), giving every vertex a
    spec and turning `SpecMismatchError`s into ERROR diagnostics at the
    offending node.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..workflow.graph import Graph, GraphId, NodeId, SinkId, SourceId
from .diagnostics import Diagnostic, Severity
from .specs import UNKNOWN, SpecMismatchError, is_known


def _label(graph: Graph, vid: GraphId) -> str:
    if isinstance(vid, NodeId):
        op = graph.get_operator(vid)
        try:
            return str(op.label)
        except Exception:
            return type(op).__name__
    return type(vid).__name__.replace("Id", "")


def toposort(graph: Graph) -> Tuple[List[GraphId], List[Diagnostic]]:
    """Kahn's algorithm over sources+nodes+sinks. Unlike `linearize`
    (depth-first, recursion-based) this cannot blow the stack and
    reports cycles as diagnostics instead of recursing forever."""
    indeg: Dict[GraphId, int] = {s: 0 for s in graph.sources}
    for n, deps in graph.dependencies.items():
        # distinct deps only: users_of dedupes repeated edges, so a node
        # depending twice on one vertex (CSE-merged gather branches)
        # receives a single decrement — counting multiplicity here would
        # report a false cycle
        indeg[n] = len(set(deps))
    for k in graph.sink_dependencies:
        indeg[k] = 1
    ready = deque(sorted((v for v, d in indeg.items() if d == 0),
                         key=lambda v: (type(v).__name__, v.id)))
    order: List[GraphId] = []
    while ready:
        v = ready.popleft()
        order.append(v)
        for u in graph.users_of(v):
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    diags: List[Diagnostic] = []
    if len(order) != len(indeg):
        stuck = sorted(
            (v for v, d in indeg.items() if d > 0 and v not in set(order)),
            key=lambda v: (type(v).__name__, v.id),
        )
        diags.append(Diagnostic(
            "KP001", Severity.ERROR,
            f"dependency cycle through {', '.join(map(str, stuck))}",
            vertex=stuck[0] if stuck else None,
            label=_label(graph, stuck[0]) if stuck else "",
        ))
    return order, diags


def _produces_transformer(graph: Graph, dep) -> Optional[bool]:
    """Does vertex ``dep`` statically produce a TransformerExpression?
    True/False when provable, None when unknowable (e.g. a source)."""
    from ..workflow.expressions import TransformerExpression
    from ..workflow.operators import EstimatorOperator, ExpressionOperator

    if not isinstance(dep, NodeId):
        return None
    op = graph.get_operator(dep)
    if isinstance(op, EstimatorOperator):
        return True
    if isinstance(op, ExpressionOperator):
        return isinstance(op.expression, TransformerExpression)
    return False


def structural_pass(graph: Graph) -> List[Diagnostic]:
    from ..workflow.operators import (
        DelegatingOperator,
        EstimatorOperator,
        TransformerOperator,
    )

    _, diags = toposort(graph)

    for node in sorted(graph.operators, key=lambda n: n.id):
        op = graph.get_operator(node)
        deps = graph.get_dependencies(node)
        label = _label(graph, node)

        if isinstance(op, DelegatingOperator):
            if len(deps) < 2:
                diags.append(Diagnostic(
                    "KP002", Severity.ERROR,
                    f"DelegatingOperator needs a transformer dependency plus "
                    f"data, got {len(deps)} dependency(ies)",
                    vertex=node, label=label))
            elif _produces_transformer(graph, deps[0]) is False:
                diags.append(Diagnostic(
                    "KP004", Severity.ERROR,
                    f"first dependency {deps[0]} produces data, not a "
                    "transformer — the fit/apply wiring is inverted",
                    vertex=node, label=label))
        elif isinstance(op, TransformerOperator):
            if not deps:
                diags.append(Diagnostic(
                    "KP002", Severity.ERROR,
                    "TransformerOperator requires at least one data dependency",
                    vertex=node, label=label))
        elif isinstance(op, EstimatorOperator):
            if not deps:
                diags.append(Diagnostic(
                    "KP002", Severity.ERROR,
                    "EstimatorOperator requires training data dependencies",
                    vertex=node, label=label))

        # fit-before-use: an estimator's output is a transformer, not
        # data — only a consumer's declared ``estimator_positions``
        # (position 0 of a DelegatingOperator; the leading slots of a
        # fused super-node, workflow.fusion_rule.FusedChainOperator) may
        # consume it.
        if isinstance(op, EstimatorOperator):
            for user in graph.users_of(node):
                if isinstance(user, SinkId):
                    diags.append(Diagnostic(
                        "KP003", Severity.WARNING,
                        "estimator output bound to a sink: forcing it runs "
                        "the fit and returns the raw transformer",
                        vertex=node, label=label))
                    continue
                user_op = graph.get_operator(user)
                user_deps = graph.get_dependencies(user)
                est_positions = getattr(user_op, "estimator_positions", ())
                positions = [i for i, d in enumerate(user_deps) if d == node]
                if positions and len(positions) == 1 and \
                        positions[0] in est_positions:
                    continue
                diags.append(Diagnostic(
                    "KP003", Severity.ERROR,
                    f"estimator output consumed as data by "
                    f"{_label(graph, user)}@{user} — fit it through a "
                    "DelegatingOperator (`.with_data(...)`) first",
                    vertex=node, label=label))

    for source in sorted(graph.sources):
        if not graph.users_of(source):
            diags.append(Diagnostic(
                "KP005", Severity.WARNING,
                "source has no consumers; the pipeline ignores this input",
                vertex=source, label="Source"))

    return diags


def spec_pass(
    graph: Graph,
    source_specs: Optional[Dict[SourceId, Any]] = None,
    seeds: Optional[Dict[Any, Any]] = None,
) -> Tuple[Dict[GraphId, Any], List[Diagnostic]]:
    """Propagate abstract specs vertex by vertex in topological order.

    No device work: every default hook runs on meta tensors, and hooks
    that cannot tell return UNKNOWN. A `SpecMismatchError` from a hook
    becomes an ERROR diagnostic at the node, and UNKNOWN flows on, so one
    mismatch does not cascade.

    ``seeds`` maps interior vertices to declared boundary `DataSpec`s
    (the serving certifier's ingress declarations): a seed fills in a
    vertex whose propagated element is unknown and never overrides one
    that propagation proved."""
    source_specs = source_specs or {}
    seeds = seeds or {}
    order, cycle_diags = toposort(graph)
    diags: List[Diagnostic] = list(cycle_diags)
    specs: Dict[GraphId, Any] = {}

    for vid in order:
        if isinstance(vid, SourceId):
            specs[vid] = source_specs.get(vid, UNKNOWN)
        elif isinstance(vid, SinkId):
            specs[vid] = specs.get(graph.get_sink_dependency(vid), UNKNOWN)
        else:
            op = graph.get_operator(vid)
            in_specs = [specs.get(d, UNKNOWN)
                        for d in graph.get_dependencies(vid)]
            try:
                out = op.abstract_eval(in_specs)
            except SpecMismatchError as e:
                diags.append(Diagnostic(
                    e.rule, Severity.ERROR, str(e),
                    vertex=vid, label=_label(graph, vid)))
                out = UNKNOWN
            except Exception as e:  # a buggy hook must not kill validation
                diags.append(Diagnostic(
                    "KP101", Severity.WARNING,
                    f"abstract_eval hook raised {type(e).__name__}: {e}",
                    vertex=vid, label=_label(graph, vid)))
                out = UNKNOWN
            if vid in seeds and not is_known(getattr(out, "element", None)):
                out = seeds[vid]
            specs[vid] = out
    return specs, diags
