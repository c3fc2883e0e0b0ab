"""Batched application over host items of mixed shapes, with an
overlapped host-to-card stream.

Counterpart of `keystone_tpu/utils/batching.py:61-553, 669-695`:
`prefetch_iterator` (a bounded producer thread whose errors re-raise at
the consumer and which an early close cancels), the chunk planner
(`_pad_target`, `_plan_chunks`: items bucketed by shape, a bucket split
into chunks, a ragged tail zero-padded up the power-of-two ladder or to
the chunk), the stacking and splitting of chunks (`_stack_chunk` and
`_split_result` there, `_stack_unit` and `_split_unit` here), the
serial and the overlapped streams, the megafused groups
(`_megafused_groups`, with its cap of 64 trips) and
`map_host_batched_stream` / `map_host_batched`.

What differs on the card:

- **Units.** A stream runs units: a chunk, or a megafused group of a
  bucket's chunks stacked as one tensor. Both take the same serial or
  overlapped stream.
- **The overlapped stream.** A producer thread stacks unit k+1 into a
  ring of ``prefetch_depth + 1`` pinned host buffers, copies it with
  ``non_blocking=True`` on a copy stream of its own and records an
  event; the compute stream waits on that event before it runs unit
  k+1, and the unit's device memory is marked used by the compute
  stream (``record_stream``). A pinned buffer is refilled only after its
  last copy's event has completed.
- **Results stay on the card.** A chunk's payload is its result tensor,
  whose rows are the chunk's items in order (phantom rows sliced off);
  the JAX package's deferred host pulls have no counterpart.
- **Megafusion.** A fused transformer's batch function (one that names
  its ``owner``) runs a megafused group as one padded loop of
  chunk-sized trips through its owner (`FusedBatchTransformer.run_rung`:
  eagerly at first, then one replay of a CUDA graph of the loop,
  `utils/graphs.py`); on the CPU the same padded loop runs eagerly. Any
  other callable runs chunk by chunk. A capture that fails raises: there
  is no fallback.

Telemetry, at JAX's sites and names: the producer's blocked puts
(``prefetch.producer_stall_s``), the consumer's waits
(``prefetch.consumer_wait_s``), the queue depth (``prefetch.queue_depth``);
one ``chunk`` span a unit (``chunk_serial``; ``chunk_stage`` on the
producer's lane and ``chunk_drain`` on the consumer's when overlapped),
``overlap.chunks_dispatched``, ``overlap.inflight_results``,
``overlap.resident_chunks``, the pinned ring's peak
(``overlap.peak_pinned_bytes``, a gauge whose ``max`` is the most a
stream held) and one `record_dispatch` a unit run.

Spill windows (`:555-667`) are not ported (ROADMAP queue 1, item 10).
`bucket_by_shape` and `run_chunked` serve device-resident buckets, which
need no staging.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from time import perf_counter
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..telemetry.instrument import record_dispatch
from ..telemetry.metrics import counter, gauge, histogram
from ..telemetry.spans import span

_PRODUCER_STALL = histogram("prefetch.producer_stall_s")
_CONSUMER_WAIT = histogram("prefetch.consumer_wait_s")
_QUEUE_DEPTH = gauge("prefetch.queue_depth")
_INFLIGHT = gauge("overlap.inflight_results")
_RESIDENT = gauge("overlap.resident_chunks")
_DISPATCHED = counter("overlap.chunks_dispatched")
_PEAK_PINNED = gauge("overlap.peak_pinned_bytes")


#: "use the resolved chunk size" (distinct from None: one chunk a bucket)
USE_CONFIG_CHUNK = object()


def _resolve_chunk(chunk):
    if chunk is USE_CONFIG_CHUNK:
        from ..workflow.env import resolved_chunk_size

        return resolved_chunk_size()
    return chunk


def _shape_key(x) -> tuple:
    shape = x.shape if hasattr(x, "shape") else np.asarray(x).shape
    return tuple(shape), str(getattr(x, "dtype", None))


def bucket_by_shape(items: Sequence) -> List[List[int]]:
    """Indices of the items grouped by (shape, dtype), groups in order of
    first appearance, indices ascending within a group."""
    groups: Dict[tuple, List[int]] = {}
    for i, x in enumerate(items):
        groups.setdefault(_shape_key(x), []).append(i)
    return list(groups.values())


def run_chunked(fn: Callable[[torch.Tensor], torch.Tensor],
                stacked: torch.Tensor,
                chunk=USE_CONFIG_CHUNK) -> torch.Tensor:
    """``fn`` over rows already on the device, in leading-axis slices of
    at most ``chunk`` (default ``ExecutionConfig.chunk_size``; None: all
    at once), the results concatenated. ``fn`` must act on each item of
    the leading axis alone."""
    chunk = _resolve_chunk(chunk)
    n = stacked.shape[0]
    if chunk is None or n <= chunk:
        return fn(stacked)
    return torch.cat([fn(stacked[i:i + chunk]) for i in range(0, n, chunk)])


# --------------------------------------------------------------------------
# The bounded producer thread


class _ProducerError:
    """An exception carried out of a producer thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def _bounded_put(q: "queue.Queue", item, cancel: threading.Event) -> bool:
    """A put that gives up once ``cancel`` is set, so a consumer that
    stopped draining never leaves the producer blocked. Its blocked time
    is the producer's stall."""
    t0 = perf_counter()
    try:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False
    finally:
        _PRODUCER_STALL.observe(perf_counter() - t0)


def prefetch_iterator(it: Iterable, depth: Optional[int] = None) -> Iterator:
    """Drain ``it`` in a background thread through a queue bounded at
    ``depth`` (default ``ExecutionConfig.prefetch_depth``), yielding its
    items in order. A producer exception re-raises at the consumer's next
    pull; closing the generator early cancels the producer and joins it.
    With the overlap engine off it is ``it`` itself."""
    from ..workflow.env import execution_config

    cfg = execution_config()
    if not cfg.overlap:
        yield from it
        return
    if depth is None:
        depth = cfg.prefetch_depth
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    cancel = threading.Event()

    def producer():
        try:
            for item in it:
                # counted before the put: the gauge may read one high,
                # never negative
                _QUEUE_DEPTH.add(1)
                if not _bounded_put(q, (item,), cancel):
                    _QUEUE_DEPTH.add(-1)
                    return
        except BaseException as e:  # re-raised at the consumer
            _bounded_put(q, _ProducerError(e), cancel)
            return
        _bounded_put(q, _DONE, cancel)

    t = threading.Thread(target=producer, name="keystone-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            t0 = perf_counter()
            msg = q.get()
            _CONSUMER_WAIT.observe(perf_counter() - t0)
            if msg is _DONE:
                break
            if isinstance(msg, _ProducerError):
                raise msg.exc
            _QUEUE_DEPTH.add(-1)
            yield msg[0]
    finally:
        cancel.set()
        while True:  # unblock a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=60.0)


# --------------------------------------------------------------------------
# Chunk planning


def _pad_target(n: int, chunk: Optional[int], bucket_n: int) -> int:
    """Rows a chunk of ``n`` items pads to: the chunk size for the tail
    of a bucket that fills at least one chunk, else the power-of-two
    ladder (1, 2, 4, ... chunk)."""
    if chunk is None or n == chunk:
        return n
    if bucket_n >= chunk:
        return chunk
    return min(chunk, 1 << max(0, n - 1).bit_length())


def _plan_chunks(items: Sequence, chunk: Optional[int],
                 pad: bool = False) -> List[Tuple[List[int], int]]:
    """``(indices, pad_to)`` chunks: the items bucketed by shape and
    dtype, each bucket split into chunks of at most ``chunk`` (None: one
    a bucket), ``pad_to`` from `_pad_target` where ``pad``."""
    plan: List[Tuple[List[int], int]] = []
    for idxs in bucket_by_shape(items):
        step = chunk or len(idxs)
        for start in range(0, len(idxs), step):
            part = idxs[start:start + step]
            pad_to = (_pad_target(len(part), chunk, len(idxs)) if pad
                      else len(part))
            plan.append((part, pad_to))
    return plan


class _PinnedRing:
    """``slots`` pinned host buffers used in turn, each refilled only
    after the copy out of it has completed; ``peak_bytes`` is the most
    they held at once."""

    def __init__(self, slots: int):
        self.buffers: List[Optional[torch.Tensor]] = [None] * slots
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0
        self.peak_bytes = 0

    def acquire(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.buffers[i]
        if buf is None or buf.numel() < nbytes:
            buf = self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8,
                                                pin_memory=True)
        self.peak_bytes = max(self.peak_bytes, sum(
            b.numel() for b in self.buffers if b is not None))
        return i, buf[:nbytes]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _stack_host(arrays: List[np.ndarray], pad_to: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Equal-shape host arrays stacked, zero rows appended up to
    ``pad_to``: into ``out`` (a host tensor of that shape, e.g. a view of
    a pinned buffer) where given."""
    n, first = len(arrays), arrays[0]
    if out is None:
        out = torch.empty((pad_to,) + first.shape,
                          dtype=_torch_dtype(first.dtype))
    view = out.numpy()
    np.concatenate([a[None] for a in arrays], axis=0, out=view[:n])
    if pad_to > n:
        view[n:] = 0
    return out


def _stack_unit(items, entries, device: torch.device,
                ring: Optional[_PinnedRing] = None, copy_stream=None):
    """``(rows, event)``: a unit's chunks (``(indices, pad_to)`` entries)
    stacked as one tensor on ``device``, each chunk's items followed by
    zero rows up to its ``pad_to`` (phantoms that `_split_unit` slices
    off). Items already on the card are stacked there. Host items are
    stacked on the host, into a pinned buffer of ``ring`` where given,
    and copied on ``copy_stream``, whose completion ``event`` marks
    (None where the copy is ordered already)."""
    first = items[entries[0][0][0]]
    if isinstance(first, torch.Tensor) and first.device.type != "cpu":
        parts = []
        for part, pad_to in entries:
            rows = torch.stack([items[i] for i in part])
            if pad_to > len(part):
                rows = torch.cat([rows, rows.new_zeros(
                    (pad_to - len(part),) + tuple(rows.shape[1:]))])
            parts.append(rows)
        return (parts[0] if len(parts) == 1 else torch.cat(parts)), None
    arrays = [[np.asarray(items[i]) for i in part] for part, _ in entries]
    item = arrays[0][0]
    shape = (sum(p for _, p in entries),) + item.shape
    dtype = _torch_dtype(item.dtype)
    pinned = ring is not None and device.type == "cuda"
    if pinned:
        slot, buf = ring.acquire(shape[0] * item.nbytes)
        host = buf.view(dtype).view(shape)
    else:
        host = torch.empty(shape, dtype=dtype)
    start = 0
    for chunk, (_, pad_to) in zip(arrays, entries):
        _stack_host(chunk, pad_to, host[start:start + pad_to])
        start += pad_to
    if not pinned:
        return host.to(device), None
    with torch.cuda.stream(copy_stream):
        rows = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(copy_stream)
    ring.events[slot] = event
    return rows, event


def _ready(rows: torch.Tensor, event, device: torch.device) -> None:
    """Order the compute stream after ``rows``' copy, and mark the rows
    used by it, so their memory is not reused before it has run."""
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        rows.record_stream(current)


def _split_unit(res, entries):
    """``(indices, rows)`` per chunk: each chunk's real rows of ``res``."""
    start = 0
    for part, pad_to in entries:
        yield part, res[start:start + len(part)]
        start += pad_to


def _stream_serial(items, units, device):
    """Stack, run, yield: one unit at a time."""
    for i, (entries, run) in enumerate(units):
        with span("chunk_serial", cat="chunk", idx=i,
                  rows=sum(len(part) for part, _ in entries)):
            rows, _ = _stack_unit(items, entries, device)
            record_dispatch()
            res = run(rows)
        yield from _split_unit(res, entries)


def _stream_overlapped(items, units, depth: int, device):
    """The producer stacks and copies unit k+1 (`prefetch_iterator`)
    while the card runs unit k; at most ``depth + 1`` results are held
    before the oldest is yielded, so at most 2·depth + 2 units are
    resident: depth queued, one being stacked, depth + 1 run. The pinned
    ring has ``depth + 1`` buffers."""
    ring = copy_stream = None
    if device.type == "cuda":
        ring = _PinnedRing(depth + 1)
        copy_stream = torch.cuda.Stream(device)

    staged_count = [0]  # units the producer has stacked, not yet run
    staged_lock = threading.Lock()

    def bump_staged(d: int) -> None:
        with staged_lock:
            staged_count[0] += d

    def stage(i, unit):
        entries, run = unit
        bump_staged(1)
        with span("chunk_stage", cat="chunk", idx=i,
                  rows=sum(len(part) for part, _ in entries)):
            return entries, run, _stack_unit(items, entries, device, ring,
                                             copy_stream)

    staged = prefetch_iterator((stage(i, u) for i, u in enumerate(units)),
                               depth)
    inflight: deque = deque()

    def note_residency():
        _INFLIGHT.set(len(inflight))
        _RESIDENT.set(len(inflight) + staged_count[0])

    def drain(idx):
        entries0, res0 = inflight.popleft()
        note_residency()
        with span("chunk_drain", cat="chunk", idx=idx,
                  rows=sum(len(part) for part, _ in entries0)):
            return list(_split_unit(res0, entries0))

    try:
        drained = 0
        for entries, run, (rows, event) in staged:
            bump_staged(-1)
            _ready(rows, event, device)
            record_dispatch()
            inflight.append((entries, run(rows)))
            _DISPATCHED.inc()
            note_residency()
            if len(inflight) > depth:
                yield from drain(drained)
                drained += 1
        while inflight:
            yield from drain(drained)
            drained += 1
    finally:
        staged.close()  # an early exit or a failure cancels the producer
        if ring is not None:
            _PEAK_PINNED.set(ring.peak_bytes)


# --------------------------------------------------------------------------
# Megafused host dispatch: a bucket's chunk loop as one call of its chain

#: chunks one megafused call runs at most: bounds its residency at about
#: 2 × trips × chunk rows (input and output)
_MEGAFUSED_MAX_TRIPS = 64


def _megafusable_batch_fn(batch_fn) -> bool:
    """Only a fused transformer's batch function (it names its
    ``owner``) is captured: a host callable might synchronize or read
    the host, neither of which a graph can hold."""
    return getattr(batch_fn, "owner", None) is not None


def _megafused_groups(items, plan):
    """``(entries, stackable)`` runs of a bucket's plan entries, split at
    `_MEGAFUSED_MAX_TRIPS`; ``stackable``: two or more chunks of one
    padded width."""
    buckets: List[List] = []
    by_shape: dict = {}
    for part, pad_to in plan:
        key = _shape_key(items[part[0]])
        if key not in by_shape:
            by_shape[key] = []
            buckets.append(by_shape[key])
        by_shape[key].append((part, pad_to))
    groups: List[Tuple[List, bool]] = []
    for entries in buckets:
        for i in range(0, len(entries), _MEGAFUSED_MAX_TRIPS):
            run = entries[i:i + _MEGAFUSED_MAX_TRIPS]
            groups.append(
                (run, len(run) > 1 and len({p for _, p in run}) == 1))
    return groups


def _units(items, plan, batch_fn, megafuse: bool):
    """``(entries, run)`` units in plan order: where ``megafuse``, a
    stackable run of a fused chain's chunks is one unit that its owner
    runs as one padded loop of chunk-sized trips
    (`FusedBatchTransformer.run_rung`: one graph replay once captured);
    every other chunk is a unit of its own that ``batch_fn`` runs."""
    if not megafuse:
        return [([entry], batch_fn) for entry in plan]
    owner = batch_fn.owner
    units: List[Tuple[List, Callable]] = []
    for entries, stackable in _megafused_groups(items, plan):
        if not stackable:
            units.extend(([entry], batch_fn) for entry in entries)
            continue
        pad = entries[0][1]
        units.append((entries, lambda rows, pad=pad: owner.run_rung(
            rows, rows.shape[0], pad)))
    return units


def map_host_batched_stream(items: Sequence, batch_fn: Callable,
                            chunk=USE_CONFIG_CHUNK, device=None
                            ) -> Iterator[Tuple[List[int], torch.Tensor]]:
    """``(indices, rows)`` per chunk, in bucket-major order: ``indices``
    are positions in ``items`` (their union is ``range(len(items))``)
    and ``rows`` the chunk's results on the device, one row an item.
    ``chunk``: items a chunk (default ``ExecutionConfig.chunk_size``;
    None: one chunk a bucket). ``device``: where host items are stacked
    (None: the card). ``batch_fn`` must act on each row alone: padded
    tails run at the padded width and their phantom rows never leave
    this module."""
    from ..device import resolve_device
    from ..workflow.env import execution_config

    chunk = _resolve_chunk(chunk)
    device = resolve_device(device)
    cfg = execution_config()
    plan = _plan_chunks(items, chunk, pad=cfg.pad_chunks)
    units = _units(items, plan, batch_fn,
                   cfg.megafusion and cfg.pad_chunks and len(plan) > 1
                   and _megafusable_batch_fn(batch_fn))
    if cfg.overlap and len(plan) > 1:
        return _stream_overlapped(items, units, cfg.prefetch_depth, device)
    return _stream_serial(items, units, device)


def map_host_batched(items: Sequence, batch_fn: Callable,
                     chunk=USE_CONFIG_CHUNK, device=None) -> List:
    """``batch_fn`` on items of any shapes, bucketed and chunked by
    `map_host_batched_stream`; the per-item results (rows of the
    chunks' results, on the device) in item order."""
    out: List = [None] * len(items)
    for part, rows in map_host_batched_stream(items, batch_fn, chunk,
                                              device):
        for i, r in zip(part, rows):
            out[i] = r
    return out
