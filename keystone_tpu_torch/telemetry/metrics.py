"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of `keystone_tpu/telemetry/metrics.py:1-303`, with JAX's
names. The executor, the host stream, megafusion, the solver loops and
the kernel builds all report into one named-metric namespace, so the
auto-cacher, profiler reports and trace exports cannot disagree about
what was observed.

Metric names are dotted and stable (the port's list; `__init__.py`
names each one's source):

  executor.node_forces / node_failures / memo_hits / prefix_saves
                                            (counters)
  executor.live_bytes                       (gauge; .max = observed peak)
  prefetch.queue_depth                      (gauge)
  prefetch.producer_stall_s / consumer_wait_s   (histograms, seconds)
  overlap.inflight_results                  (gauge)
  overlap.peak_pinned_bytes                 (gauge; .max = the most
                                             pinned host bytes a stream
                                             held)
  overlap.bytes_staged / chunks_dispatched  (counters)
  solver.steps                              (counter)
  dispatch.programs_executed                (counter; one per batched
                                             call boundary or graph
                                             replay, see
                                             instrument.record_dispatch)
  dispatch.scheduler_runs / scheduled_tasks (counters; concurrent DAG
                                             scheduler activity)
  dispatch.warmup_failures                  (counter)
  dispatch.programs_compiled                (counter; one per cold
                                             library build or graph
                                             capture, see compile_events)
  dispatch.compile_cache_hits               (counter; a library built
                                             earlier, only loaded)
  compile.cold_secs / warm_secs             (histograms, seconds)
  megafusion.programs / graph_captures / graph_replays / scan_trips
                                            (counters)

Thread-safety: one process lock (`LOCK`) guards mutation; producer
threads and the main thread share these. A caller that updates several
metrics at once (the per-request scope) takes `LOCK` once and calls the
unlocked ``_add``/``_observe``. `MetricsRegistry.reset` zeroes the
metrics in place, so a module may look a metric up once and keep it (the
JAX package drops them).
"""

from __future__ import annotations

import random
import threading
import zlib
from contextlib import contextmanager
from typing import Dict, Optional

from . import spans as _spans

LOCK = threading.Lock()


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with LOCK:
            self.value += n

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value}

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Point-in-time level with a high-water mark. ``set``/``add`` also
    emit a counter sample into the active tracer (when one is installed)
    so the level is a time series in the Chrome trace, not just a max."""

    __slots__ = ("name", "value", "max")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        with LOCK:
            self.value = v
            if v > self.max:
                self.max = v
        self._sample(v)

    def add(self, d: float) -> float:
        with LOCK:
            v = self._add(d)
        self._sample(v)
        return v

    def _add(self, d: float) -> float:
        """`add` for a caller holding `LOCK`, without the sample (the
        caller emits it with `_sample` after releasing the lock)."""
        self.value += d
        v = self.value
        if v > self.max:
            self.max = v
        return v

    def _sample(self, v: float) -> None:
        t = _spans.current_tracer()
        if t is not None:
            t.counter_sample(self.name, v)

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value, "max": self.max}

    def reset(self) -> None:
        self.value = 0.0
        self.max = 0.0


#: Histogram reservoir capacity. 512 float samples ≈ 4 KiB per metric —
#: a long-lived serving process holds a fixed few KiB per histogram no
#: matter how many observations arrive, yet p50/p99 stay readable
#: (standard error of a reservoir quantile at n=512 is ~2% at p50).
RESERVOIR_SIZE = 512


class Histogram:
    """Streaming count/sum/min/max plus a FIXED-SIZE uniform reservoir
    (Vitter's Algorithm R) so percentiles are readable without retaining
    samples unboundedly. The exact aggregates (count/total/min/max) are
    what reports and tests assert on; `percentile` answers from the
    reservoir — an unbiased uniform sample of everything observed —
    while memory stays O(RESERVOIR_SIZE) forever."""

    __slots__ = ("name", "count", "total", "min", "max",
                 "_reservoir", "_rng")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max = 0.0
        self._reservoir: list = []
        # deterministic per-name seed: reproducible snapshots in tests
        # without coupling separate histograms' sampling decisions
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float) -> None:
        with LOCK:
            self._observe(v)

    def _observe(self, v: float) -> None:
        """`observe` for a caller holding `LOCK`."""
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._reservoir) < RESERVOIR_SIZE:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self._reservoir[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Reservoir-estimated q-quantile (q in [0, 1]); 0.0 when empty.
        Linear interpolation between order statistics."""
        with LOCK:
            data = sorted(self._reservoir)
        if not data:
            return 0.0
        if len(data) == 1:
            return data[0]
        pos = max(0.0, min(1.0, q)) * (len(data) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(data) - 1)
        frac = pos - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total": self.total,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
        }

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = 0.0
        self._reservoir = []
        self._rng = random.Random(zlib.crc32(self.name.encode()))


class MetricsRegistry:
    """Name→metric table. ``counter``/``gauge``/``histogram`` create on
    first use; a name is one kind forever (a config bug, not a race —
    raise loudly)."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict, name: str, cls):
        m = table.get(name)
        if m is None:
            for other in (self.counters, self.gauges, self.histograms):
                if other is not table and name in other:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(other[name]).__name__}"
                    )
            with LOCK:
                m = table.setdefault(name, cls(name))
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self.counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self.gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self.histograms, name, Histogram)

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """JSON-ready view: {counters: {...}, gauges: {...},
        histograms: {...}} — embedded verbatim in trace exports."""
        return {
            "counters": {k: v.snapshot() for k, v in sorted(self.counters.items())},
            "gauges": {k: v.snapshot() for k, v in sorted(self.gauges.items())},
            "histograms": {
                k: v.snapshot() for k, v in sorted(self.histograms.items())
            },
        }

    def reset(self) -> None:
        """Zero every metric in place (tests; a fresh measurement): a
        handle a module holds stays the registered metric."""
        with LOCK:
            for table in (self.counters, self.gauges, self.histograms):
                for m in table.values():
                    m.reset()


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


class MetricsDelta:
    """Counter deltas over one measured window, against the
    process-cumulative registry.

    Every per-example measurement used to hand-roll
    ``before = c.value; ...; c.value - before`` against the cumulative
    counters; this is that idiom, once::

        with metrics_delta() as d:
            predictor(test).get()
        programs = d.counter("dispatch.programs_executed")

    ``counter(name)`` is the window's increment (0.0 for a counter that
    did not exist or did not move); ``counters()`` is every nonzero
    delta. Gauges and histograms are cumulative-by-design (high-water
    marks, streaming totals) and are deliberately not delta'd here —
    read their snapshots directly. Reentrant and thread-compatible: the
    baseline is captured once at ``__enter__`` and never mutated."""

    def __init__(self, reg: Optional[MetricsRegistry] = None):
        self._registry = reg or _registry
        self._base: Dict[str, float] = {}

    def __enter__(self) -> "MetricsDelta":
        with LOCK:
            self._base = {
                name: c.value for name, c in self._registry.counters.items()
            }
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def counter(self, name: str) -> float:
        c = self._registry.counters.get(name)
        current = c.value if c is not None else 0.0
        return current - self._base.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with LOCK:
            for name, c in self._registry.counters.items():
                d = c.value - self._base.get(name, 0.0)
                if d:
                    out[name] = d
        return out


def metrics_delta(reg: Optional[MetricsRegistry] = None) -> MetricsDelta:
    """Snapshot-delta context over the process-cumulative counter
    registry (see `MetricsDelta`)."""
    return MetricsDelta(reg)


def counter(name: str) -> Counter:
    return _registry.counter(name)


# --------------------------------------------------------------------------
# Counts that a CUDA graph replays

class _TallyLocal(threading.local):
    #: this thread's sink, or None for the counters (a class default:
    #: reading it takes no failed attribute lookup)
    sink = None


#: per thread: the sink its counts go into, or None for the counters
_tally_local = _TallyLocal()


def tally(obj, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to ``obj.<attr>`` (a registry `Counter`: to its value),
    or to this thread's sink while one is installed by `tallied`.

    Code run during a CUDA graph's capture runs once and never at
    replay, so a count taken there would undercount every replay: a
    capture collects its counts in a sink, and `utils/graphs.py` adds
    them again at each replay. A warm-up's run counts into a sink that
    is dropped. Plain attribute counts, shared by the scheduler's and
    warm-up threads, take the registry's lock too."""
    sink = _tally_local.sink
    if sink is None:
        with LOCK:
            _add_count(obj, attr, n)
        return
    entry = sink.setdefault((id(obj), attr), [obj, attr, 0])
    entry[2] += n


def tally_all(counts) -> None:
    """`tally` of each ``(obj, attr, n)`` of ``counts`` (a graph
    replay's), under one acquisition of the lock where no sink is
    installed."""
    sink = _tally_local.sink
    if sink is not None:
        for obj, attr, n in counts:
            tally(obj, attr, n)
        return
    with LOCK:
        for obj, attr, n in counts:
            _add_count(obj, attr, n)


def _add_count(obj, attr: str, n) -> None:
    if isinstance(obj, Counter):
        obj.value += n
    else:
        setattr(obj, attr, getattr(obj, attr) + n)


@contextmanager
def tallied(sink: dict):
    """Within, this thread's `tally` calls add to ``sink`` (keyed by
    object and attribute: ``[obj, attr, n]`` entries), not to the
    counters."""
    prev = _tally_local.sink
    _tally_local.sink = sink
    try:
        yield sink
    finally:
        _tally_local.sink = prev


def tallying() -> bool:
    """Whether this thread's counts go into a sink (a capture or a
    warm-up is running)."""
    return _tally_local.sink is not None


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)
