"""Continuous micro-batching onto the certified pad ladder.

Counterpart of `keystone_tpu/serving/batcher.py`. Concurrent single-row
requests land in a bounded queue (depth ``KEYSTONE_SERVING_QUEUE_DEPTH``)
and one dispatcher thread coalesces them, up to the envelope's
``max_batch`` and within a ``KEYSTONE_SERVING_WINDOW_MS`` window, into
one stacked batch a dispatch. The batcher never pads: the runtime's
`ServingRuntime._apply_batch` pads the batch to its pow-2 rung (the
`_pad_target` arithmetic), the ladder the certificate was issued for and
the warm step captured, and slices the riders' rows back out, so a warm
server replays for any coalesced count.

Overload is shed, not buffered: a full queue refuses the request with
`ShedError`, counts ``serving.shed_total`` and dumps the flight ring
(``tag="shed"``).

Kill switch: ``KEYSTONE_SERVING_COALESCE=0`` starts no dispatcher:
`submit` applies the single-row batch on the caller's thread, the direct
`FittedPipeline.apply` path (same rows, rung 1).

Counts: ``serving.dispatches`` (one a dispatch), the
``serving.coalesced_batch`` histogram (rows a dispatch) and the
``serving.queue_depth`` gauge.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np

from ..telemetry.flight import flight_snapshot
from ..telemetry.metrics import counter, gauge, histogram
from ..workflow.env import execution_config


class ShedError(RuntimeError):
    """Raised at submit time when the bounded ingress queue is full —
    the load-shed discipline: overload is refused immediately, never
    buffered into unbounded memory or unbounded queueing delay."""


class _Pending:
    """One in-flight request: the validated ingress row, and an event
    the dispatcher fires once the per-row result (or error) lands."""

    __slots__ = ("row", "done", "result", "error")

    def __init__(self, row: np.ndarray):
        self.row = row
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent single-row requests into ladder-shaped
    batches for ``apply_fn`` (which must map a stacked ``(n, ...)``
    batch to an ``(n, ...)`` result)."""

    def __init__(self, apply_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int, name: str = "serving"):
        cfg = execution_config()
        self.apply_fn = apply_fn
        self.max_batch = max(1, int(max_batch))
        self.coalesce = bool(cfg.serving_coalesce)
        self.window_s = float(cfg.serving_window_ms) / 1e3
        # bounded, so overload becomes a shed and not unbounded memory
        self.depth = int(cfg.serving_queue_depth)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=self.depth)
        self._shed = counter("serving.shed_total")
        self._depth_gauge = gauge("serving.queue_depth")
        self._coalesced = histogram("serving.coalesced_batch")
        self._dispatched = counter("serving.dispatches")
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._name = name

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self.coalesce and self._thread is None:
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name=f"{self._name}-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stopping = True
        try:
            self._queue.put(None, timeout=timeout)
        except queue.Full:
            pass
        thread.join(timeout=timeout)
        self._thread = None

    # -- request path -------------------------------------------------

    def submit(self, row: np.ndarray, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block until the row's result is available; raises `ShedError`
        when the ingress queue is full and re-raises any dispatch
        error."""
        if not self.coalesce or self._thread is None:
            # kill switch: the request applied on its caller's thread, as
            # a direct FittedPipeline.apply
            out = self.apply_fn(row[np.newaxis, ...])
            self._dispatched.inc()
            self._coalesced.observe(1)
            return np.asarray(out)[0]
        pending = _Pending(row)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            self._shed.inc()
            flight_snapshot(tag="shed")
            raise ShedError(
                f"ingress queue full (depth={self.depth}) — request shed")
        self._depth_gauge.set(self._queue.qsize())
        if not pending.done.wait(timeout):
            raise TimeoutError("request timed out awaiting dispatch")
        if pending.error is not None:
            raise pending.error
        assert pending.result is not None
        return pending.result

    # -- dispatcher ---------------------------------------------------

    def _drain_batch(self) -> List[Optional[_Pending]]:
        """Block for the first request, then coalesce followers until
        the envelope's max_batch or the window closes."""
        first = self._queue.get()
        batch: List[Optional[_Pending]] = [first]
        if first is None:
            return batch
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0:
                    item = self._queue.get_nowait()
                else:
                    item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            if item is None:
                break
        return batch

    def _run(self) -> None:
        while True:
            batch = self._drain_batch()
            stop = batch and batch[-1] is None
            requests = [p for p in batch if p is not None]
            self._depth_gauge.set(self._queue.qsize())
            if requests:
                self._dispatch(requests)
            if stop or self._stopping:
                return

    def _dispatch(self, requests: List[_Pending]) -> None:
        stacked = np.stack([p.row for p in requests])
        self._coalesced.observe(len(requests))
        self._dispatched.inc()
        try:
            out = np.asarray(self.apply_fn(stacked))
            if out.shape[0] < len(requests):
                raise RuntimeError(
                    f"apply returned {out.shape[0]} rows for a batch of "
                    f"{len(requests)}")
            for i, p in enumerate(requests):
                p.result = out[i]
        except BaseException as e:  # noqa: BLE001 - fanned to callers
            for p in requests:
                p.error = e
        finally:
            for p in requests:
                p.done.set()
