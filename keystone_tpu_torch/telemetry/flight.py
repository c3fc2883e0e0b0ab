"""Always-on bounded flight recorder.

Counterpart of `keystone_tpu/telemetry/flight.py:1-285`. A fixed-
capacity ring of the most recent closed spans and counter samples,
populated passively by the span tee (`spans.add_tee`), so it rides
along whether or not a scoped `trace_run` tracer is active, and dumped
as a valid Chrome trace on demand:

  - ``flight_snapshot(path)``, programmatic;
  - ``SIGUSR2``, installed by `ensure_flight` only when it runs on the
    main thread (the handler copies the ring and writes JSON);
  - a conformance watchdog breach (`watchdog.ConformanceWatchdog`).

Spans still open when a dump fires are exported as incomplete but
parseable events (``args.incomplete``), the active scoped tracer's
included. The rings hold `DEFAULT_CAPACITY` spans and counter samples
each (``KEYSTONE_FLIGHT_CAPACITY`` overrides); overflow evicts the
oldest and counts evictions in the dump metadata. Dumps go under
``KEYSTONE_FLIGHT_DIR`` (default: the temporary directory). With
``KEYSTONE_LIVE_TELEMETRY=0`` `ensure_flight` returns None and no tee
is installed.
"""

from __future__ import annotations

import itertools
import os
import signal
import tempfile
import threading
from typing import Any, Dict, List, Optional

from .spans import SpanRecord, Tracer, add_tee, current_tracer, remove_tee

#: default ring capacity (spans and counter samples each). 4096 spans
#: at ~200 B/record ≈ under 1 MiB resident — hours of serving context
#: at per-request span granularity.
DEFAULT_CAPACITY = 4096


class _Ring:
    """Fixed-capacity append ring. A lock (not a bare deque) because
    dumps iterate while worker threads append — `collections.deque`
    raises "mutated during iteration" under exactly that race.
    ``dropped`` counts evictions so dumps can report their window
    honestly."""

    __slots__ = ("_cap", "_buf", "_start", "_lock", "dropped")

    def __init__(self, capacity: int):
        self._cap = max(1, int(capacity))
        self._buf: List[Any] = []
        self._start = 0  # index of the oldest element (circular)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, item: Any) -> None:
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(item)
            else:
                self._buf[self._start] = item
                self._start = (self._start + 1) % self._cap
                self.dropped += 1

    def snapshot(self) -> List[Any]:
        """Oldest-first copy, safe against concurrent appends."""
        with self._lock:
            return self._buf[self._start:] + self._buf[:self._start]

    def __iter__(self):
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._start = 0
            self.dropped = 0


class FlightRecorder(Tracer):
    """A `Tracer` whose span / counter stores are bounded rings, fed
    two ways: directly (the watchdog's request spans when no scoped
    tracer is active) and via the span tee (copies of every closed span
    any other tracer records). It is never installed as the ACTIVE
    tracer — `spans.span()`'s no-op fast path and `telemetry_active()`
    stay exactly as they were (the kill-switch bit-for-bit contract).

    Teed records keep their original span ids (hierarchy among them
    survives); the recorder's own ids start at 10**9 so the two spaces
    cannot collide. Timestamps are re-anchored to the recorder's epoch.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        self.capacity = max(1, int(capacity))
        self.spans = _Ring(self.capacity)  # type: ignore[assignment]
        self.counter_samples = _Ring(self.capacity)  # type: ignore[assignment]
        self._ids = itertools.count(10 ** 9)
        self.metadata["flight"] = {"capacity": self.capacity}

    # ------------------------------------------------------------- tee

    def tee_span(self, src: Tracer, rec: SpanRecord) -> None:
        offset = src.epoch - self.epoch
        cp = SpanRecord(rec.name, rec.cat, rec.t0 + offset, rec.tid,
                        rec.sid, rec.parent, dict(rec.args))
        cp.dur = rec.dur
        cp.error = rec.error
        self.spans.append(cp)

    def tee_counter(self, src: Tracer, name: str, t: float, value: float,
                    tid: int) -> None:
        self.counter_samples.append(
            (name, t + (src.epoch - self.epoch), value, tid))

    # ----------------------------------------------------------- dumps

    def open_spans(self) -> List[SpanRecord]:
        """The recorder's own in-flight spans PLUS the active scoped
        tracer's (re-anchored copies) — a dump racing an open
        ``megafused_program`` span still shows it."""
        out = super().open_spans()
        src = current_tracer()
        if src is not None and src is not self:
            offset = src.epoch - self.epoch
            for rec in src.open_spans():
                cp = SpanRecord(rec.name, rec.cat, rec.t0 + offset,
                                rec.tid, rec.sid, rec.parent,
                                dict(rec.args))
                out.append(cp)
        return out

    def dump(self, path: str) -> str:
        """Write the ring as a Chrome trace (atomic rename, same as any
        trace export). Ring metadata rides in ``keystone.flight``."""
        self.metadata["flight"] = {
            "capacity": self.capacity,
            "spans_held": len(self.spans),
            "dropped_spans": self.spans.dropped,
            "counter_samples_held": len(self.counter_samples),
            "dropped_counter_samples": self.counter_samples.dropped,
        }
        from .export import write_trace

        return write_trace(self, path)


# ---------------------------------------------------------- module state

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
_signal_installed = False
_dump_seq = itertools.count(1)


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get(
            "KEYSTONE_FLIGHT_CAPACITY", str(DEFAULT_CAPACITY))))
    except ValueError:
        return DEFAULT_CAPACITY


_config = None  # `workflow.env`, imported at first use (it imports us)


def env_module():
    """`keystone_tpu_torch.workflow.env`, imported once, at first use."""
    global _config
    if _config is None:
        from ..workflow import env

        _config = env
    return _config


def _live_enabled() -> bool:
    return env_module().execution_config().live_telemetry


def ensure_flight() -> Optional[FlightRecorder]:
    """The process flight recorder, creating (and installing its tee +
    SIGUSR2 handler) on first call. None when the live telemetry plane
    is disabled (``KEYSTONE_LIVE_TELEMETRY=0``) — in that case nothing
    is installed and the process behaves exactly as before this module
    existed."""
    global _recorder
    if not _live_enabled():
        return None
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                rec = FlightRecorder(capacity=_env_capacity())
                add_tee(rec)
                _recorder = rec
                _install_signal_handler()
    return _recorder


def flight_recorder() -> Optional[FlightRecorder]:
    """The current recorder without creating one."""
    return _recorder


def reset_flight() -> None:
    """Tear down the process recorder (tests). The SIGUSR2 handler
    stays installed — it no-ops without a recorder."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            remove_tee(_recorder)
            _recorder = None


def _default_dump_path(tag: str = "") -> str:
    base = os.environ.get("KEYSTONE_FLIGHT_DIR") or tempfile.gettempdir()
    label = f"_{tag}" if tag else ""
    name = (f"keystone_flight_{os.getpid()}"
            f"_{next(_dump_seq)}{label}.json")
    return os.path.join(base, name)


def flight_snapshot(path: Optional[str] = None, tag: str = "") -> Optional[str]:
    """Dump the flight ring as a Chrome trace; returns the written path
    or None when the plane is disabled. ``path=None`` writes under
    ``KEYSTONE_FLIGHT_DIR`` (default: the system temp dir) with a
    pid-and-sequence-stamped name; ``tag`` labels the file (e.g.
    ``"breach"``)."""
    rec = ensure_flight()
    if rec is None:
        return None
    if path is None:
        path = _default_dump_path(tag)
    try:
        return rec.dump(path)
    except OSError:
        return None  # an unwritable dir must never break serving


def _on_sigusr2(signum, frame) -> None:
    rec = _recorder
    if rec is not None:
        try:
            rec.dump(_default_dump_path("sigusr2"))
        except Exception:
            pass  # a signal handler must never raise into the main loop


def _install_signal_handler() -> None:
    """SIGUSR2 → dump. Only from the main thread (CPython restriction),
    only once, and never on platforms without SIGUSR2 (Windows)."""
    global _signal_installed
    if _signal_installed or not hasattr(signal, "SIGUSR2"):
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
        _signal_installed = True
    except (ValueError, OSError):
        pass  # embedded interpreters may refuse; dumps stay programmatic


def flight_health() -> Dict[str, Any]:
    """Ring occupancy digest for `streaming.health` consumers."""
    rec = _recorder
    if rec is None:
        return {"armed": False}
    return {
        "armed": True,
        "capacity": rec.capacity,
        "spans_held": len(rec.spans),
        "dropped_spans": rec.spans.dropped,
    }
