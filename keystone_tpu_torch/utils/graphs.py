"""A chunk loop captured as one CUDA graph.

No module of the JAX package corresponds to this one: there, a megafused
apply is one XLA program whose chunk loop is a ``lax.scan``
(`keystone_tpu/nodes/util/fusion.py:745-804`,
`keystone_tpu/utils/batching.py:357-553`), compiled once per input shape.
On the card its counterpart is a CUDA graph of the loop's launches,
captured once per (item shape, dtype, rows, trip) and replayed: one
launch of the graph in place of a Python dispatch per kernel.

A graph reads and writes fixed addresses (K4's ``__grid_constant__``
chain and its pointers are fixed at capture), so a `CapturedLoop` owns
its input buffer: a call copies the rows in, zeroes the padded tail,
replays, and returns a copy of its rows of the output, which the next
replay overwrites. Right before the capture the loop runs once eagerly
on the capture stream: that loads the kernel libraries and builds the
launch plans, neither of which may happen during a capture. Where the
capture is made for a call, that eager run is the call's own run and its
rows are the call's result; a warm-up's eager run is on zero rows and
counts nowhere. The capture runs in ``thread_local`` mode under one
process-wide lock, so the executor's worker and warm-up threads may go
on launching while it runs. The loop keeps the chain's launch plans and
stages (``keep``) alive as long as its graph, since the graph reads
their buffers; it holds no reference to its owner, so the graph is freed
with the transformer that keeps it.

Launch counts: the wrappers count in Python (`telemetry/metrics.py::
tally`), so they count at capture and never at replay. The capture's
counts (``per_replay``, their counters held weakly) are added to the
counters at every replay, under one acquisition of the registry's lock.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from ..telemetry.metrics import tallied, tally_all

#: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()

#: device index → the stream the loops warm up and capture on
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device)
    return stream


def _weak(obj):
    try:
        return weakref.ref(obj)
    except TypeError:  # no weak references to it: held, as it is
        return lambda: obj


class CapturedLoop:
    """``fn`` over a static (rows, *item) input, captured as one graph.

    ``x``: the rows of the call the capture is made for (at most
    ``rows``); the eager run before the capture runs on them, counted,
    and ``first`` is its result. None for a warm-up: the eager run is on
    zero rows and counts nowhere. ``keep``: what the graph reads and
    ``fn`` does not own (launch plans, stage parameters)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 shape: Tuple[int, ...], dtype: torch.dtype,
                 device: torch.device, x: Optional[torch.Tensor] = None,
                 keep=()):
        self.rows = shape[0]
        self.keep = keep
        self.lock = threading.Lock()
        self.static_in = torch.zeros(shape, dtype=dtype, device=device)
        sink: dict = {}
        self.first = None
        current = torch.cuda.current_stream(device)
        if x is not None:
            self.static_in[:x.shape[0]].copy_(x)
        # the capture stream is shared: even a wait or an event record on
        # it from another thread would join that thread's capture
        with _CAPTURE_LOCK:
            stream = _capture_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                if x is None:
                    with tallied({}):
                        fn(self.static_in)
                else:
                    self.first = fn(self.static_in)[:x.shape[0]].clone()
                self.graph = torch.cuda.CUDAGraph()
                with tallied(sink):
                    self.graph.capture_begin(
                        capture_error_mode="thread_local")
                    try:
                        self.static_out = fn(self.static_in)
                    finally:
                        self.graph.capture_end()
            current.wait_stream(stream)
        if self.first is not None:
            self.first.record_stream(current)
        # the counters held weakly: a count of the owner would otherwise
        # keep it, and with it this graph, alive in a reference cycle
        self.per_replay = [(_weak(obj), attr, n)
                           for obj, attr, n in sink.values()]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``fn`` of ``x`` (at most ``rows`` rows) by one replay."""
        n = x.shape[0]
        with self.lock:
            self.static_in[:n].copy_(x)
            if n < self.rows:
                self.static_in[n:].zero_()
            self.graph.replay()
            out = self.static_out[:n].clone()
        tally_all([(obj, attr, n) for obj, attr, n in
                   ((ref(), attr, n) for ref, attr, n in self.per_replay)
                   if obj is not None])
        return out
