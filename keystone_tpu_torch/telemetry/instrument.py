"""Node-force instrumentation: the one wrapper every profile consumer
shares.

Counterpart of `keystone_tpu/telemetry/instrument.py:1-251`.
`GraphExecutor` wraps each node's lazy Expression through
`instrument_node_force` while a tracer or a profiler is installed; the
wrapper times the real force (try/finally, so a thunk that raises still
reports its elapsed time and bumps the failure counter), estimates the
output's bytes once per force with `estimate_bytes`, opens a
``cat="node"`` span under the active tracer, feeds the observed live-set
accounting, and notifies the attached profiler. Streaming expressions,
which consumers drain through ``iter_chunks()`` without running the
memoized thunk, are instrumented at the chunk generator instead
(`_instrument_stream`). `utils/profiling.py::ExecutionProfiler` and
`workflow/autocache.py::profile_nodes` both consume these completions,
so cache decisions and profile reports cannot disagree.

Timing (JAX's rule, `:20-26`): with a profiler attached the forced value
is synchronized (`torch.cuda.synchronize` for a value on the card), so
the card's work lands on the node that queued it. So it is under a
tracer made with ``synchronize=True`` (each streamed chunk too), whose
node spans then carry the card's seconds. Any other tracer injects no
sync: node spans then measure what the host queued and waited for, and
a traced run makes the same synchronizing calls as an untraced one.

The per-process dimension (JAX's `process_dim`, `:44-90`): in a
`torch.distributed` group every process dispatches its own launches, so
each count also lands on ``dispatch.programs_executed.p<rank>``.
Without a group there is no second counter.
"""

from __future__ import annotations

from time import perf_counter
from typing import Optional

import numpy as np

import torch
import torch.distributed as dist

from .metrics import counter, gauge, tallying
from .spans import current_tracer

_PROGRAMS = counter("dispatch.programs_executed")
_NODE_FORCES = counter("executor.node_forces")
_NODE_FAILURES = counter("executor.node_failures")
_LIVE_BYTES = gauge("executor.live_bytes")


def process_dim() -> Optional[str]:
    """The per-process accounting dimension: ``p<rank>`` inside a
    `torch.distributed` group (one process per card), None without one,
    where a second counter would duplicate the total. Read at each call:
    a group may be joined after the first dispatch."""
    if dist.is_available() and dist.is_initialized():
        return f"p{dist.get_rank()}"
    return None


def record_dispatch(n: int = 1) -> None:
    """Count ``n`` executed programs against
    ``dispatch.programs_executed``. On the card a program is one batched
    call at JAX's sites: a `Dataset.map_batches` call (a fused chain's,
    a megafused chain's padded loop, eager or a graph replay), a host
    stream unit, a solver step and its prepare and finalize, and the
    node-level batched calls (the patchers, the windower, the scaler's
    and linear solvers' fits). Always on: the tests and `chip_smoke.py`
    read the counter directly. Nothing is counted while a graph is
    captured or a warm-up runs (`tallying`): neither executes a
    program. In a process group each count also lands on
    ``dispatch.programs_executed.p<rank>`` (`process_dim`)."""
    if not tallying():
        _PROGRAMS.inc(n)
        dim = process_dim()
        if dim is not None:
            counter(f"dispatch.programs_executed.{dim}").inc(n)


def estimate_bytes(value) -> float:
    """Bytes a forced value holds, read from shapes, never synced:
    tensors by ``numel() * element_size()``, arrays by ``nbytes``,
    strings and bytes by length, containers summed, other leaves at a
    nominal 64. Datasets unwrap to their payload: a `HostDataset`'s
    stacked buckets where it has them, else its items; a device
    `Dataset`'s rows; a host CSR's arrays."""
    if isinstance(value, torch.Tensor):
        return float(value.numel() * value.element_size())
    if isinstance(value, np.ndarray):
        return float(value.nbytes)
    if isinstance(value, (bytes, str)):
        return float(len(value))
    if isinstance(value, (tuple, list)):
        return float(sum(estimate_bytes(v) for v in value))
    if isinstance(value, dict):
        return float(sum(estimate_bytes(v) for v in value.values()))
    buckets = getattr(value, "_buckets", None)
    if buckets is not None:
        return float(sum(estimate_bytes(t) for _, t in buckets))
    items = getattr(value, "_items", None)
    if items is not None:
        return estimate_bytes(items)
    matrix = getattr(value, "matrix", None)
    if matrix is not None and hasattr(matrix, "indptr"):
        return float(matrix.data.nbytes + matrix.indices.nbytes
                     + matrix.indptr.nbytes)
    data = getattr(value, "data", None)
    if data is not None and data is not value:
        return estimate_bytes(data)
    return 64.0


def sync_value(value) -> None:
    """Wait until the card has produced ``value`` (a tensor, or anything
    with a ``device``); nothing for a value on the CPU."""
    device = value.device if isinstance(value, torch.Tensor) else getattr(
        value, "device", None)
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device) and device.type == "cuda":
        torch.cuda.synchronize(device)


def _record_node(label, vertex, profiler, dt, nbytes, failed,
                 t0_rel=None, streamed=False):
    """Shared completion bookkeeping for both force paths."""
    _NODE_FORCES.inc()
    if failed:
        _NODE_FAILURES.inc()
    elif nbytes:
        # memoized outputs stay live for the executor's lifetime: the
        # running sum's high-water mark is the observed live-set peak
        # (per-run copy on the tracer; the registry gauge is cumulative
        # across runs)
        _LIVE_BYTES.add(nbytes)
        tracer = current_tracer()
        if tracer is not None:
            tracer.add_live_bytes(nbytes)
    if streamed:
        tracer = current_tracer()
        if tracer is not None and t0_rel is not None:
            # ts is the FIRST-pull timestamp (the drain window's start,
            # not the completion time the record is written at) and dur
            # stays the cumulative pull time — the consumer's
            # between-chunk work is excluded from the stage's cost, so
            # self-time math holds; drain_window_s carries the real
            # first-pull→exhaustion extent for timeline readers
            tracer.record_complete(
                f"force {label}", "node", t0_rel, dt, error=failed,
                vertex=vertex, out_bytes=nbytes, seconds=round(dt, 6),
                drain_window_s=round(max(0.0, tracer.now() - t0_rel), 6),
                streamed=True)
    if profiler is not None:
        profiler.on_force(label, dt, nbytes, failed=failed, vertex=vertex)


def _instrument_stream(label, expr, vertex, profiler):
    """Streamed stages are drained through ``iter_chunks()`` — the
    memoized ``_thunk`` never runs on that path, so wrap the chunk
    generator instead. Per-pull timing keeps the consumer's
    between-chunk work OUT of this stage's duration (drains interleave
    with downstream compute by design); on exhaustion one closed
    ``cat="node"`` span is recorded via `Tracer.record_complete`
    (``streamed=True``, ``dur`` = cumulative pull time) and the profiler
    is notified — so streamed stages appear in profiles, reconciliation,
    and live-set accounting instead of silently folding into their
    consumer. Early close (`GeneratorExit`) records nothing: the stream
    is resumable and will complete (and report) later."""
    orig_chunks = expr._chunks_thunk

    def chunks():
        it = orig_chunks()
        total = 0.0
        nbytes = 0.0
        t0_rel = None
        sync = False
        while True:
            t0 = perf_counter()
            if t0_rel is None:
                tracer = current_tracer()
                t0_rel = tracer.now() if tracer is not None else 0.0
                sync = tracer is not None and tracer.synchronize
            try:
                item = next(it)
                if sync:
                    sync_value(item[1])
            except StopIteration:
                total += perf_counter() - t0
                _record_node(label, vertex, profiler, total, nbytes,
                             failed=False, t0_rel=t0_rel, streamed=True)
                return
            except GeneratorExit:
                raise  # early close: resumable, not a completion
            except BaseException:
                total += perf_counter() - t0
                _record_node(label, vertex, profiler, total, 0.0,
                             failed=True, t0_rel=t0_rel, streamed=True)
                raise
            total += perf_counter() - t0
            try:
                nbytes += estimate_bytes(item[1])
            except Exception:
                pass
            yield item

    expr._chunks_thunk = chunks
    return expr


def instrument_node_force(
    label: str,
    expr,
    vertex: Optional[int] = None,
    profiler=None,
):
    """Wrap ``expr`` so its force reports spans + metrics + profiler
    completions. Streaming expressions get their chunk generator wrapped
    (see `_instrument_stream`); plain expressions get their thunk
    wrapped. Already-forced expressions pass through untouched. Safe to
    call with neither tracer nor profiler active — but the executor
    guards the call, so the untraced hot path never even reaches here."""
    if getattr(expr, "_chunks_thunk", None) is not None \
            and not expr.is_forced:
        return _instrument_stream(label, expr, vertex, profiler)
    orig_thunk = expr._thunk
    if orig_thunk is None:  # already forced; nothing to time
        return expr

    def forced():
        tracer = current_tracer()
        rec = None
        if tracer is not None:
            rec = tracer.start(f"force {label}", cat="node", vertex=vertex)
        t0 = perf_counter()
        value = None
        failed = False
        try:
            value = orig_thunk()
            if profiler is not None or (tracer is not None
                                        and tracer.synchronize):
                # the card's time lands on this node; a tracer that
                # does not synchronize injects no sync
                sync_value(value)
            return value
        except BaseException:
            failed = True
            raise
        finally:
            dt = perf_counter() - t0
            nbytes = 0.0
            if not failed and value is not None:
                try:
                    nbytes = estimate_bytes(value)
                except Exception:
                    nbytes = 0.0
            if rec is not None:
                tracer.end(rec, error=failed, out_bytes=nbytes,
                           seconds=round(dt, 6))
            _record_node(label, vertex, profiler, dt, nbytes, failed)

    expr._thunk = forced
    return expr
