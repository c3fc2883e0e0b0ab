"""Static per-node and peak live-memory estimation.

Counterpart of `keystone_tpu/analysis/memory.py:1-254`
(`resolve_chunk_rows`, `live_set_walk`, `MemoryEstimate`, `memory_pass`
and its KP2xx findings). With every vertex's abstract spec known (shape
× dtype × count), the pass walks the execution schedule and tracks the
live set: a vertex's output is resident from the step that produces it
until its last consumer has run. The peak of that walk is the static
device-memory watermark, known before any data loads.

The overlap engine changes residency: a streaming stage never
materializes (at most ``2·prefetch_depth + 2`` chunks are in flight,
`utils/batching.py`'s bound), but prefetch multiplies the chunk
footprint by that factor. Streaming stages get the chunk-resident
discount and a KP203 note where the amplified footprint is a meaningful
share of the budget. A megafused operator's captured chunk loop holds
its per-trip carry on top (KP204). The JAX package's host-tier windows
(out-of-core and spilled sources, host-placed caches) wait for its
out-of-core slice (ROADMAP queue 1, item 10), its per-device picture
for the sharding tier (one card holds the whole plan here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..workflow.graph import Graph, GraphId, NodeId, SinkId, SourceId
from .diagnostics import Diagnostic, Severity
from .propagate import _label, toposort
from .specs import DataSpec, element_nbytes, is_known

def resolve_chunk_rows(chunk_rows: Optional[int]) -> int:
    """An explicit ``chunk_rows`` wins; None reads the chunk the host
    batching dispatches with (`workflow.env.resolved_chunk_size`), so
    the model never assumes a chunk the runtime does not run."""
    if chunk_rows is not None:
        return chunk_rows
    from ..workflow.env import resolved_chunk_size

    return resolved_chunk_size()


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _may_stream(op) -> bool:
    """Statically: could this operator's output arrive chunk-by-chunk
    under the overlap engine? True for declared stream producers
    (overridden ``apply_batch_stream``/``batch_transform_stream``) and
    chunk-passthrough stages (``chunkable``)."""
    if getattr(op, "chunkable", False):
        return True
    from ..workflow.pipeline import Transformer

    fn = getattr(type(op), "apply_batch_stream", None)
    return fn is not None and fn is not Transformer.apply_batch_stream


@dataclass
class MemoryEstimate:
    """Static memory picture of one graph."""

    per_node: Dict[NodeId, Optional[int]] = field(default_factory=dict)
    resident: Dict[NodeId, Optional[int]] = field(default_factory=dict)
    peak_bytes: int = 0
    peak_at: Optional[GraphId] = None
    unknown_nodes: int = 0
    #: one card's picture, filled in by `sharding.per_device_pass` at
    #: the full tier: residency scaled by each node's shard
    per_device: Dict[NodeId, Optional[int]] = field(default_factory=dict)
    per_device_peak_bytes: int = 0
    per_device_peak_at: Optional[GraphId] = None

    def __repr__(self) -> str:
        return (
            f"MemoryEstimate(peak={_fmt_bytes(self.peak_bytes)} at "
            f"{self.peak_at}, {self.unknown_nodes} unknown node(s))"
        )


def live_set_walk(
    graph: Graph,
    order: List[GraphId],
    residents: Dict[NodeId, Optional[int]],
) -> Tuple[int, Optional[GraphId]]:
    """The live-set walk: a vertex's output is live from production
    through its last consumer's schedule position, and sinks pin their
    dependency forever. Returns ``(peak_bytes, peak_at)``."""
    sched_pos = {v: i for i, v in enumerate(order)}
    last_use: Dict[NodeId, int] = {}
    pinned: set = set()
    for vid in residents:
        users = graph.users_of(vid)
        if any(isinstance(u, SinkId) for u in users):
            pinned.add(vid)
        last_use[vid] = max(
            (sched_pos[u] for u in users if u in sched_pos),
            default=sched_pos.get(vid, 0),
        )

    live = 0
    peak = 0
    peak_at: Optional[GraphId] = None
    expiring: Dict[int, List[NodeId]] = {}
    for vid, end in last_use.items():
        expiring.setdefault(end, []).append(vid)
    for i, v in enumerate(order):
        if isinstance(v, NodeId) and residents.get(v) is not None:
            live += residents[v]
            if live > peak:
                peak, peak_at = live, v
        for dead in expiring.get(i, ()):
            if dead not in pinned and residents.get(dead) is not None:
                live -= residents[dead]
    return peak, peak_at


def memory_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    hbm_budget_bytes: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
    overlap: Optional[bool] = None,
) -> Tuple[MemoryEstimate, List[Diagnostic]]:
    from ..workflow.env import execution_config

    cfg = execution_config()
    chunk_rows = resolve_chunk_rows(chunk_rows)
    if prefetch_depth is None:
        prefetch_depth = cfg.prefetch_depth
    if overlap is None:
        overlap = cfg.overlap
    if hbm_budget_bytes is None:
        hbm_budget_bytes = cfg.hbm_budget_bytes
    inflight_chunks = 2 * prefetch_depth + 2  # utils/batching.py bound

    order, _ = toposort(graph)
    est = MemoryEstimate()
    diags: List[Diagnostic] = []

    # Residency per produced vertex: full bytes, discounted for streaming.
    for vid in order:
        if not isinstance(vid, NodeId):
            continue
        spec = specs.get(vid)
        op = graph.get_operator(vid)
        full = spec.nbytes if isinstance(spec, DataSpec) else None
        est.per_node[vid] = full
        if full is None:
            est.unknown_nodes += 1
            est.resident[vid] = None
            continue
        resident = full
        # the host tier (`:172-194`): a host-placed cache's output and an
        # out-of-core or spilled source live in host memory; the card
        # holds two windows of their rows
        host_tier = getattr(op, "placement", None) == "host"
        if not host_tier:
            ds = getattr(op, "dataset", None)
            host_tier = bool(getattr(ds, "is_out_of_core", False)
                             or getattr(ds, "is_spilled", False))
        if host_tier and isinstance(spec, DataSpec):
            per_elem = element_nbytes(spec.element)
            if per_elem is not None:
                window_bytes = per_elem * chunk_rows * 2
                if window_bytes < full:
                    resident = window_bytes
            est.resident[vid] = resident
            continue
        if overlap and isinstance(spec, DataSpec) and spec.kind == "dataset" \
                and (spec.streaming or _may_stream(op)):
            per_elem = element_nbytes(spec.element)
            if per_elem is not None:
                chunk_bytes = per_elem * chunk_rows * inflight_chunks
                if chunk_bytes < full:
                    resident = chunk_bytes
                    if hbm_budget_bytes and chunk_bytes > hbm_budget_bytes // 20:
                        diags.append(Diagnostic(
                            "KP203", Severity.INFO,
                            f"overlap amplification: {inflight_chunks} "
                            f"in-flight chunks × {_fmt_bytes(per_elem * chunk_rows)}"
                            f"/chunk = {_fmt_bytes(chunk_bytes)} resident "
                            f"(prefetch_depth={prefetch_depth})",
                            vertex=vid, label=_label(graph, vid)))
        # a megafused loop holds its stacked input (priced at the
        # producer) plus its per-trip carry, one chunk's largest pair of
        # stage boundaries, in place of intermediates that are no graph
        # nodes: the operator knows its own stage trail
        scan_hook = getattr(op, "scan_live_nbytes", None)
        if scan_hook is not None and full is not None:
            try:
                dep_specs = [specs.get(d)
                             for d in graph.get_dependencies(vid)]
                scan_live = scan_hook(dep_specs, chunk_rows)
            except Exception:
                scan_live = None
            if scan_live:
                resident += int(scan_live)
                if hbm_budget_bytes and scan_live > hbm_budget_bytes // 20:
                    diags.append(Diagnostic(
                        "KP204", Severity.INFO,
                        f"megafused loop live-set: "
                        f"{_fmt_bytes(int(scan_live))} of "
                        f"per-trip carry (chunk_rows={chunk_rows}) rides "
                        "on top of the stacked input and output "
                        "residency",
                        vertex=vid, label=_label(graph, vid)))
        est.resident[vid] = resident

        if hbm_budget_bytes and full > hbm_budget_bytes:
            diags.append(Diagnostic(
                "KP201", Severity.WARNING,
                f"materialized output is {_fmt_bytes(full)}, over the "
                f"{_fmt_bytes(hbm_budget_bytes)} device memory budget"
                + (" (streams under overlap, resident "
                   f"{_fmt_bytes(resident)})" if resident < full else ""),
                vertex=vid, label=_label(graph, vid)))

    est.peak_bytes, est.peak_at = live_set_walk(graph, order, est.resident)

    if hbm_budget_bytes and est.peak_bytes > hbm_budget_bytes:
        diags.append(Diagnostic(
            "KP202", Severity.WARNING,
            f"peak live memory {_fmt_bytes(est.peak_bytes)} exceeds the "
            f"{_fmt_bytes(hbm_budget_bytes)} device memory budget (peak at "
            f"{_label(graph, est.peak_at)}@{est.peak_at})"
            + (f"; {est.unknown_nodes} node(s) unestimated"
               if est.unknown_nodes else ""),
            vertex=est.peak_at, label=_label(graph, est.peak_at)))
    return est, diags
