"""Conformance watchdog and the per-request scope.

Counterpart of `keystone_tpu/telemetry/watchdog.py:1-280`.
`ConformanceWatchdog` holds a bound per padded request shape, built from
a certificate record dict (`from_certificate`: ``{"shapes": [{"batch",
"predicted_seconds"}], "slo_seconds", "certified"}``, the JAX package's
`ServingCertificate.as_record()` form). Armed (`arm_watchdog`), it
checks every finished request's seconds against its shape's bound; a
breach increments ``serving.slo_breaches``, dumps the flight recorder
and records a ``kind="conformance"`` ledger decision.

`request_scope` wraps every `FittedPipeline.apply`
(`workflow/pipeline.py`, as JAX's `workflow/pipeline.py:353-370`): it
tags the request with its padded shape (`utils/batching.py::_pad_target`
at the resolved chunk size), records a ``cat="request"`` span (into the
active tracer, else into the flight ring), keeps ``serving.requests``,
``serving.inflight`` and ``serving.apply_seconds``, feeds the streaming
sketch and runs the armed watchdog's check. A request's seconds are host
seconds: the scope adds no sync. With ``KEYSTONE_LIVE_TELEMETRY=0`` it
is a no-op.

Arming from a certificate computed at execution (JAX's
`workflow/executor.py:437-441`) waits for the serving certifier
(ROADMAP queue 1, items 7 and 8).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import flight
from .flight import ensure_flight, env_module
from .metrics import LOCK, counter, gauge, histogram
from .spans import current_tracer
from .streaming import _observe_apply

_REQUESTS = counter("serving.requests")
_INFLIGHT = gauge("serving.inflight")
_APPLY_SECONDS = histogram("serving.apply_seconds")


def _live_enabled() -> bool:
    return env_module().execution_config().live_telemetry


class ConformanceWatchdog:
    """Per-shape bound table + breach policy for ONE armed pipeline.

    ``bounds`` maps padded ladder batch → certified seconds (the
    certificate's per-shape ``predicted_seconds``, i.e. the KP903
    bound). A live shape with no exact entry conservatively borrows the
    bound of the smallest certified batch that covers it (bounds are
    monotone in batch); shapes larger than every certified batch are
    out of envelope — counted (``serving.uncovered_shapes``), never
    breached, because the certificate makes no claim about them."""

    def __init__(self, pipeline: str, bounds: Dict[int, float],
                 slo_seconds: Optional[float] = None,
                 certified: bool = False):
        self.pipeline = str(pipeline)
        self.bounds = {int(k): float(v) for k, v in bounds.items()}
        self.slo_seconds = slo_seconds
        self.certified = bool(certified)
        self.checked = 0
        self.breaches = 0
        self._lock = threading.Lock()

    @classmethod
    def from_certificate(cls, record: Dict[str, Any],
                         pipeline: str = "pipeline",
                         ) -> Optional["ConformanceWatchdog"]:
        """Build from a `ServingCertificate.as_record()` payload (the
        ``keystone.serving`` trace metadata / `certify_example` report
        form). None when the record carries no priced shapes."""
        shapes = (record or {}).get("shapes") or []
        bounds = {}
        for s in shapes:
            try:
                bounds[int(s["batch"])] = float(s["predicted_seconds"])
            except (KeyError, TypeError, ValueError):
                continue
        if not bounds:
            return None
        return cls(pipeline, bounds,
                   slo_seconds=record.get("slo_seconds"),
                   certified=bool(record.get("certified")))

    def bound_for(self, chunk_shape: int) -> Optional[float]:
        chunk_shape = int(chunk_shape)
        b = self.bounds.get(chunk_shape)
        if b is not None:
            return b
        covering = [n for n in self.bounds if n >= chunk_shape]
        if covering:
            return self.bounds[min(covering)]
        return None

    def check(self, chunk_shape: int, seconds: float,
              batch: Optional[int] = None) -> bool:
        """Audit one finished apply; returns True when it breached.
        Breach handling (dump + ledger record) happens inline — it is
        cheap (ring copy + one JSON write) and only on the slow path."""
        bound = self.bound_for(chunk_shape)
        with self._lock:
            self.checked += 1
        counter("serving.conformance_checks").inc()
        if bound is None:
            counter("serving.uncovered_shapes").inc()
            return False
        if seconds <= bound:
            return False
        with self._lock:
            self.breaches += 1
        counter("serving.slo_breaches").inc()
        from .flight import flight_snapshot

        dump = flight_snapshot(tag="breach")
        from .ledger import record_decision

        record_decision(
            kind="conformance",
            rule="ConformanceWatchdog",
            vertices=[],
            labels=[self.pipeline, f"shape={int(chunk_shape)}"],
            chosen={
                "entry": "breach",
                "observed_seconds": float(seconds),
                "chunk_shape": int(chunk_shape),
                "batch": int(batch) if batch is not None else None,
                "flight_dump": dump,
            },
            alternatives=[{
                "entry": "within certified bound",
                "cost_seconds": float(bound),
            }],
            predicted={
                "bound_seconds": float(bound),
                "slo_seconds": self.slo_seconds,
                "certified": self.certified,
            },
            enforced=False,  # the watchdog observes; it does not gate
        )
        return True

    def describe(self) -> Dict[str, Any]:
        """JSON-ready digest for `streaming.health` / the --live CLI."""
        with self._lock:
            checked, breaches = self.checked, self.breaches
        return {
            "armed": True,
            "pipeline": self.pipeline,
            "certified": self.certified,
            "slo_seconds": self.slo_seconds,
            "shapes": {str(n): b for n, b in sorted(self.bounds.items())},
            "checked": checked,
            "breaches": breaches,
        }


# ----------------------------------------------------------- arm / disarm

_active_watchdog: Optional[ConformanceWatchdog] = None
_arm_lock = threading.Lock()


def active_watchdog() -> Optional[ConformanceWatchdog]:
    return _active_watchdog


def arm_watchdog(record: Dict[str, Any],
                 pipeline: str = "pipeline") -> Optional[ConformanceWatchdog]:
    """Arm (or re-arm) the process watchdog from a certificate record.
    Returns the watchdog, or None when the record has no shapes or the
    live telemetry plane is disabled."""
    global _active_watchdog
    if not _live_enabled():
        return None
    wd = ConformanceWatchdog.from_certificate(record, pipeline=pipeline)
    if wd is None:
        return None
    with _arm_lock:
        _active_watchdog = wd
    ensure_flight()  # breach dumps need the ring recording already
    return wd


def disarm_watchdog() -> None:
    global _active_watchdog
    with _arm_lock:
        _active_watchdog = None


# ------------------------------------------------------ per-request scope


_pad_target = None  # `utils.batching._pad_target`, imported at first use

#: (batch, chunk size) -> padded shape, the planner's arithmetic done once
#: for each; cleared when it grows past `_PADDED_CAP` keys
_padded: Dict[Tuple[int, int], int] = {}
_PADDED_CAP = 4096


def _padded_shape(batch: int) -> int:
    """The padded leading dim this request dispatches under: the chunk
    planner's arithmetic (`_pad_target` at the resolved chunk size)."""
    global _pad_target
    key = (batch, env_module().resolved_chunk_size())
    shape = _padded.get(key)
    if shape is None:
        if _pad_target is None:
            from ..utils.batching import _pad_target
        if len(_padded) >= _PADDED_CAP:
            _padded.clear()
        shape = _padded[key] = int(_pad_target(batch, key[1], batch))
    return shape


class _NoScope:
    """The request scope with the live plane off: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NO_SCOPE = _NoScope()


class _RequestScope:
    """One live request (see `request_scope`)."""

    __slots__ = ("batch", "pipeline", "chunk_shape", "sink", "t0")

    def __init__(self, batch: int, pipeline: str):
        self.batch = int(batch)
        self.pipeline = str(pipeline)
        self.chunk_shape = _padded_shape(self.batch)

    def __enter__(self) -> int:
        # the counter and the gauge under one acquisition of the lock
        with LOCK:
            _REQUESTS.value += 1.0
            inflight = _INFLIGHT._add(1)
        _INFLIGHT._sample(inflight)
        tracer = current_tracer()
        self.sink = (tracer if tracer is not None
                     else flight.flight_recorder() or ensure_flight())
        self.t0 = self.sink.now() if self.sink is not None else 0.0
        return self.chunk_shape

    def __exit__(self, exc_type, exc, tb) -> bool:
        error = exc_type is not None
        dur = 0.0
        if self.sink is not None:
            dur = self.sink.now() - self.t0
            self.sink.record_complete(
                "apply_request", "request", self.t0, dur, error=error,
                batch=self.batch, chunk_shape=self.chunk_shape,
                pipeline=self.pipeline)
        observed = not error and dur > 0.0
        now = time.time()
        # the gauge, the histogram and the sketch under one acquisition
        with LOCK:
            inflight = _INFLIGHT._add(-1)
            if observed:
                _APPLY_SECONDS._observe(dur)
                _observe_apply((self.pipeline, self.chunk_shape), dur, now)
        _INFLIGHT._sample(inflight)
        if observed:
            wd = active_watchdog()
            if wd is not None:
                try:
                    wd.check(self.chunk_shape, dur, batch=self.batch)
                except Exception:
                    pass  # a watchdog bug must never break serving
        return False


def request_scope(batch: int, pipeline: str = "pipeline"):
    """Instrument one live apply request: a context whose value is the
    request's padded shape (None with the live plane off).

    Emits a ``cat="request"`` span (into the active tracer when one is
    scoped, else into the flight ring), keeps ``serving.requests``,
    ``serving.inflight`` and the ``serving.apply_seconds`` histogram,
    feeds the per-shape streaming sketch, and runs the armed watchdog's
    check on exit. Exceptions propagate (marked on the span). A no-op
    when ``KEYSTONE_LIVE_TELEMETRY=0``."""
    if not _live_enabled():
        return _NO_SCOPE
    return _RequestScope(batch, pipeline)
