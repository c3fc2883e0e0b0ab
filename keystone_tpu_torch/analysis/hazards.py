"""Donation and streaming hazard detection.

Counterpart of `keystone_tpu/analysis/hazards.py:1-157` (`hazard_pass`,
`megafusion_pass`, `_is_cache_node`):

  - **Donation reuse (KP301, error).** An operator that declares
    ``donates_deps = (i, ...)`` writes into dependency ``i``'s tensor in
    place. If the producing vertex is still reachable by any *other*
    consumer or sink, that consumer would read the overwritten values.
    Statically: every donated dependency's producer must have exactly
    one user.
  - **Silent stream materialization (KP302, warning).** A
    stream-producing stage feeding a non-chunkable operator forces the
    whole stage to assemble in memory — correct, but it silently
    forfeits the overlap win and the O(chunk) memory bound the producer
    was written for.
  - **Cache on a streaming stage (KP303, warning).** Cache/autocache
    nodes (``saveable`` transformers) pin their input's full value; on
    a streaming stage this materializes the stream at the cache point.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..workflow.graph import Graph, GraphId, NodeId
from ..workflow.operators import is_stream_origin as _is_stream_origin
from .diagnostics import Diagnostic, Severity
from .memory import _may_stream
from .propagate import _label
from .specs import DataSpec


def _is_cache_node(op) -> bool:
    from ..workflow.operators import TransformerOperator

    return isinstance(op, TransformerOperator) and getattr(op, "saveable", False)


def hazard_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    overlap: bool = True,
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    for node in sorted(graph.operators, key=lambda n: n.id):
        op = graph.get_operator(node)
        deps = graph.get_dependencies(node)
        label = _label(graph, node)

        # --- KP301: donated dependency still reachable elsewhere
        for i in getattr(op, "donates_deps", ()) or ():
            if i >= len(deps):
                diags.append(Diagnostic(
                    "KP002", Severity.ERROR,
                    f"donates_deps index {i} out of range for "
                    f"{len(deps)} dependency(ies)",
                    vertex=node, label=label))
                continue
            producer = deps[i]
            others = [u for u in graph.users_of(producer) if u != node]
            # the donating node itself re-reading the producer at another
            # dependency index is the same read-after-donation hazard
            # (duplicated deps are real: CSE-merged gather branches)
            self_dups = [j for j, d in enumerate(deps)
                         if d == producer and j != i]
            if others or self_dups:
                names = ", ".join(
                    [f"{_label(graph, u)}@{u}" for u in others]
                    + [f"this node's dependency index {j}"
                       for j in self_dups])
                diags.append(Diagnostic(
                    "KP301", Severity.ERROR,
                    f"dependency {i} ({_label(graph, producer)}@{producer}) "
                    f"is donated by this node but still consumed by {names}; "
                    "it would read the tensor after this node overwrites it",
                    vertex=node, label=label))

        if not overlap:
            continue

        # Streaming hazards key on whether the *input* stage streams.
        for d in deps:
            if not isinstance(d, NodeId):
                continue
            dep_spec = specs.get(d)
            dep_streams = (
                isinstance(dep_spec, DataSpec) and dep_spec.streaming
            ) or _is_stream_origin(graph.get_operator(d))
            if not dep_streams:
                continue
            if _is_cache_node(op):
                diags.append(Diagnostic(
                    "KP303", Severity.WARNING,
                    f"cache node pins the full value of streaming stage "
                    f"{_label(graph, d)}@{d}; the stream materializes here "
                    "and downstream overlap is lost",
                    vertex=node, label=label))
            elif _is_materializing_transformer(op):
                diags.append(Diagnostic(
                    "KP302", Severity.WARNING,
                    f"non-chunkable operator consumes streaming stage "
                    f"{_label(graph, d)}@{d}: the stream silently "
                    "materializes (set `chunkable = True` if the batch "
                    "path distributes over chunks)",
                    vertex=node, label=label))
    return diags


def _is_materializing_transformer(op) -> bool:
    """A transformer stage that would materialize an incoming stream —
    neither chunk-passthrough nor a stream producer itself. Estimators
    and delegates are excluded: an estimator *must* see the whole
    dataset (materialization is semantic, not silent), and a delegate's
    chunk capability depends on the fitted transformer, which does not
    exist statically."""
    from ..workflow.operators import TransformerOperator

    return (
        isinstance(op, TransformerOperator)
        and not getattr(op, "chunkable", False)
        and not _may_stream(op)
    )


def megafusion_pass(graph: Graph) -> List[Diagnostic]:
    """KP401 (info): why this plan cannot collapse to one captured chunk
    loop: `workflow.fusion_rule.megafusion_blockers` names the stages
    that interrupt an otherwise fusable chain (fan-out, host code, stream
    origins, unfusable fits). Such plans run stage by stage; this pass is
    how ``validate()`` says why."""
    try:
        from ..workflow.fusion_rule import megafusion_blockers

        blockers = megafusion_blockers(graph)
    except Exception:
        return []  # diagnosis must never break validation
    return [
        Diagnostic(
            "KP401", Severity.INFO,
            f"megafusion fallback: {reason}",
            vertex=vid, label=label)
        for vid, label, reason in blockers
    ]
