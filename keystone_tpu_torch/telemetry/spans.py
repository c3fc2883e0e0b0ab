"""Hierarchical span tracer.

Counterpart of `keystone_tpu/telemetry/spans.py:1-372`. A `Tracer`
collects closed `SpanRecord`s (named, categorized intervals with parent
attribution) from every layer of a run:

    pipeline run (trace_run)          cat="pipeline"
      optimizer phase                 cat="phase"
        node force (executor)         cat="node"
          stream chunk (batching)     cat="chunk"
          solver iteration            cat="step"
          padded loop (megafusion)    cat="node" (megafused_program)

Nesting is structural, not declared: each thread keeps a span stack per
tracer, so a node force that pulls its dependency inside its own thunk
becomes that dependency's parent, and the host stream's producer, the
scheduler's workers and the warm-up thread each get their own lane (their
tid separates them in the Chrome trace view).

Activation, cheapest first:

  - no tracer installed: `span(...)` returns a shared no-op context
    manager; the hot path costs one global read;
  - ``with trace_run("out.json"):`` scopes a tracer and writes Chrome
    trace JSON on exit;
  - ``KEYSTONE_TRACE=out.json`` (`ExecutionConfig.trace_path`) installs
    an ambient process tracer on first use and writes the file at
    interpreter exit.

A span's times are host seconds (`time.perf_counter()` from the
tracer's epoch): a tracer injects no device sync, so a node span
measures what the host queued and waited for. `capabilities()` also
names the card, its power limit and the torch and CUDA versions.
"""

from __future__ import annotations

import atexit
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

_capabilities: Dict[str, Dict[str, Any]] = {}


def record_capability(name: str, available: bool, reason: str = "") -> None:
    """Record an environment capability probe outcome (e.g. a skipped
    test's reason). Exported in every trace's metadata so bench/trace
    artifacts carry which capabilities were absent for the run."""
    _capabilities[name] = {"available": bool(available), "reason": reason}


_device: Optional[Dict[str, Any]] = None


def _device_probe() -> Dict[str, Any]:
    """The ``device`` capability, probed once: the card's name and power
    limit as ``nvidia-smi`` gives them, and the torch and CUDA
    versions."""
    global _device
    if _device is None:
        import subprocess

        import torch

        versions = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
        if torch.cuda.is_available():
            try:
                card = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=10).stdout.strip().splitlines()[0]
            except (OSError, IndexError, subprocess.SubprocessError):
                card = torch.cuda.get_device_name(0)
            _device = {"available": True, "reason": f"{card}; {versions}"}
        else:
            _device = {"available": False, "reason": f"no card; {versions}"}
    return _device


def capabilities() -> Dict[str, Dict[str, Any]]:
    return {"device": _device_probe(), **_capabilities}


class SpanRecord:
    """One closed span. ``t0``/``dur`` are seconds relative to the
    tracer epoch; ``sid``/``parent`` link the hierarchy."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "sid", "parent",
                 "args", "error")

    def __init__(self, name: str, cat: str, t0: float, tid: int, sid: int,
                 parent: Optional[int], args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = 0.0
        self.tid = tid
        self.sid = sid
        self.parent = parent
        self.args = args
        self.error = False


class Tracer:
    """Span + counter-sample collector. Append-only lists mutated under
    the GIL (list.append is atomic); per-thread span stacks live in a
    `threading.local` so producer threads nest independently."""

    def __init__(self):
        self.epoch = time.perf_counter()
        self.wall_epoch = time.time()
        self.spans: List[SpanRecord] = []
        self.counter_samples: List[tuple] = []  # (name, t, value, tid)
        self.metadata: Dict[str, Any] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        # sid → still-open SpanRecord, so a dump/export racing an open
        # span can emit it as incomplete-but-parseable instead of
        # dropping it (dict add/pop are atomic under the GIL)
        self._open: Dict[int, SpanRecord] = {}

    # ------------------------------------------------------------ spans

    def _stack(self) -> List[SpanRecord]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def start(self, name: str, cat: str = "span", **args) -> SpanRecord:
        st = self._stack()
        rec = SpanRecord(
            name,
            cat,
            time.perf_counter() - self.epoch,
            threading.get_ident(),
            next(self._ids),
            st[-1].sid if st else None,
            args,
        )
        st.append(rec)
        self._open[rec.sid] = rec
        return rec

    def end(self, rec: SpanRecord, error: bool = False, **args) -> None:
        rec.dur = time.perf_counter() - self.epoch - rec.t0
        rec.error = error
        if args:
            rec.args.update(args)
        st = self._stack()
        # tolerate exception-path unwinding that skipped inner ends
        while st and st[-1] is not rec:
            st.pop()
        if st:
            st.pop()
        self._open.pop(rec.sid, None)
        self.spans.append(rec)
        if _TEES:
            _tee_span(self, rec)

    def record_complete(self, name: str, cat: str, t0: float, dur: float,
                        error: bool = False, **args) -> SpanRecord:
        """Append an already-closed span without touching the stack —
        for measurements whose lifetime does not nest cleanly (a
        streamed stage's drain interleaves with its consumer). Parent is
        whatever span is open on this thread right now. ``t0`` is
        seconds relative to this tracer's epoch."""
        st = self._stack()
        rec = SpanRecord(
            name, cat, t0, threading.get_ident(), next(self._ids),
            st[-1].sid if st else None, args,
        )
        rec.dur = dur
        rec.error = error
        self.spans.append(rec)
        if _TEES:
            _tee_span(self, rec)
        return rec

    def now(self) -> float:
        """Seconds since this tracer's epoch (for `record_complete`)."""
        return time.perf_counter() - self.epoch

    def open_spans(self) -> List[SpanRecord]:
        """Snapshot of the spans still open right now (dump/export use:
        each is emitted as an incomplete-but-parseable event). The list
        is a copy; the records themselves are live."""
        return list(self._open.values())

    def counter_sample(self, name: str, value: float) -> None:
        t = time.perf_counter() - self.epoch
        tid = threading.get_ident()
        self.counter_samples.append((name, t, value, tid))
        if _TEES:
            _tee_counter(self, name, t, value, tid)

    # ------------------------------------------------- live-set tracking

    def add_live_bytes(self, nbytes: float) -> None:
        """Per-run observed live-set accounting: node outputs are
        memoized for their executor's lifetime, so the running sum's
        high-water mark is THIS run's observed peak (the process-global
        `executor.live_bytes` gauge is cumulative across runs)."""
        live = self.metadata.get("observed_live_bytes", 0.0) + nbytes
        self.metadata["observed_live_bytes"] = live
        if live > self.metadata.get("observed_live_peak_bytes", 0.0):
            self.metadata["observed_live_peak_bytes"] = live


class _SpanCtx:
    """Context manager binding one span to one tracer. Exceptions close
    the span (marked ``error``) and propagate."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_rec")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: Dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._rec = None

    def __enter__(self) -> SpanRecord:
        self._rec = self._tracer.start(self._name, self._cat, **self._args)
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer.end(self._rec, error=exc_type is not None)
        return False


class _NoopSpan:
    """Shared do-nothing context manager for the untraced hot path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:  # `if span_ctx:` idiom in instrumentation
        return False


_NOOP = _NoopSpan()

# ------------------------------------------------------------------ tees
#
# A tee is a passive sink (the flight recorder) that receives a copy of
# every CLOSED span and counter sample any tracer records — so the
# always-on ring stays populated even while a scoped `trace_run` tracer
# owns the active slot. The registry is an immutable tuple swapped
# whole-sale (read is one global load; the hot path pays a falsy check
# when no tee is installed). A tee that is itself a Tracer never
# receives its own records.

_TEES: tuple = ()


def add_tee(sink) -> None:
    """Register ``sink`` (needs ``tee_span(src, rec)`` and
    ``tee_counter(src, name, t, value, tid)``) to receive copies of all
    closed spans / counter samples from every tracer. Idempotent."""
    global _TEES
    if sink not in _TEES:
        _TEES = _TEES + (sink,)


def remove_tee(sink) -> None:
    global _TEES
    _TEES = tuple(s for s in _TEES if s is not sink)


def _tee_span(src: Tracer, rec: SpanRecord) -> None:
    for sink in _TEES:
        if sink is src:
            continue
        try:
            sink.tee_span(src, rec)
        except Exception:
            pass  # telemetry must never take down the measured run


def _tee_counter(src: Tracer, name: str, t: float, value: float,
                 tid: int) -> None:
    for sink in _TEES:
        if sink is src:
            continue
        try:
            sink.tee_counter(src, name, t, value, tid)
        except Exception:
            pass


# ---------------------------------------------------------------- active

_active: Optional[Tracer] = None
_ambient_checked = False


def _env_trace_path() -> Optional[str]:
    from ..workflow.env import execution_config

    return execution_config().trace_path


def _flush_ambient(path: str) -> None:
    global _active
    t = _active
    if t is not None:
        from .export import write_trace

        try:
            write_trace(t, path)
        except OSError:
            pass


def current_tracer() -> Optional[Tracer]:
    """The installed tracer, or None. On first call, honors
    ``KEYSTONE_TRACE``/`ExecutionConfig.trace_path` by installing an
    ambient tracer flushed at process exit."""
    global _active, _ambient_checked
    if _active is None and not _ambient_checked:
        _ambient_checked = True
        try:
            path = _env_trace_path()
        except Exception:
            path = None
        if path:
            _active = Tracer()
            atexit.register(_flush_ambient, path)
    return _active


def telemetry_active() -> bool:
    return current_tracer() is not None


def span(name: str, cat: str = "span", **args):
    """Open a span under the active tracer; a shared no-op when tracing
    is off (one global read, zero allocation)."""
    t = current_tracer()
    if t is None:
        return _NOOP
    return _SpanCtx(t, name, cat, args)


class trace_run:
    """Scope a tracer (and optionally write its Chrome trace on exit):

        with trace_run("run.json") as tracer:
            pipeline(data).get()

    ``path=None`` falls back to `ExecutionConfig.trace_path` (the
    ``KEYSTONE_TRACE`` env var); with neither, the trace is only held in
    memory on the yielded tracer. Nests: the previous tracer is restored
    on exit. Opens a root ``cat="pipeline"`` span so every run has a
    top-level interval."""

    def __init__(self, path: Optional[str] = None, name: str = "pipeline_run"):
        self._path = path
        self._name = name
        self._prev: Optional[Tracer] = None
        self._root = None
        self.tracer = Tracer()

    def __enter__(self) -> Tracer:
        global _active
        self._prev = _active
        _active = self.tracer
        self._root = self.tracer.start(self._name, cat="pipeline")
        return self.tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active
        self.tracer.end(self._root, error=exc_type is not None)
        _active = self._prev
        path = self._path
        if path is None:
            try:
                path = _env_trace_path()
            except Exception:
                path = None
        if path:
            from .export import write_trace

            write_trace(self.tracer, path)
        return False


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install ``tracer`` process-wide (None uninstalls). `trace_run` is
    the structured form; this exists for hosts that manage lifecycle
    themselves (bench child processes)."""
    global _active
    _active = tracer
