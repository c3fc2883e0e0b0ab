"""Streaming quantile sketches and the live request-latency table.

Counterpart of `keystone_tpu/telemetry/streaming.py:1-314`. A long-lived
process answers "what is my apply latency's p99 at padded shape 64 right
now?" without keeping samples: one `QuantileSketch` per (pipeline,
padded shape), a fixed-memory histogram sketch in the Ben-Haim/Yom-Tov
streaming style, surfaced through `health()` and the ``python -m
keystone_tpu_torch.telemetry --live`` rendering.

  - fixed memory: at most ``max_bins`` (centroid, count) pairs;
  - mergeable: ``merge`` combines two sketches bin-wise, then compacts;
  - exact count, sum, min and max ride alongside.

The table is process-global and guarded by the metrics registry's lock
(`metrics.LOCK`, so that a request updates its histogram, gauge and
sketch under one acquisition), reset by `reset_live()`,
and fed by `watchdog.request_scope` (every `FittedPipeline.apply`) while
the live plane is on (``KEYSTONE_LIVE_TELEMETRY``, default on). The
seconds are host seconds: no sync is added to measure them.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import LOCK as _LOCK

#: default sketch width: 64 (centroid, count) bins ≈ 1 KiB — interior
#: quantile error for unimodal latency data is well under one bin width
DEFAULT_MAX_BINS = 64


class QuantileSketch:
    """Fixed-memory streaming quantile sketch (Ben-Haim/Yom-Tov
    streaming-parallel decision-tree histogram): keep at most
    ``max_bins`` weighted centroids sorted by value; inserting past
    capacity merges the two closest adjacent centroids (weighted mean).
    Quantiles interpolate the cumulative weight curve. All mutation is
    caller-locked (the module table holds one lock) or single-threaded.
    """

    __slots__ = ("max_bins", "count", "total", "min", "max", "_vals",
                 "_wts", "_gaps")

    def __init__(self, max_bins: int = DEFAULT_MAX_BINS):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = int(max_bins)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # the bins as parallel lists, sorted by value: centroids, their
        # weights, and the gaps between neighbours, kept up to date so
        # that an insert and a merge cost a few list operations
        self._vals: List[float] = []
        self._wts: List[float] = []
        self._gaps: List[float] = []

    @property
    def _bins(self) -> List[List[float]]:
        """``[value, weight]`` pairs, sorted (JAX's representation)."""
        return [[v, w] for v, w in zip(self._vals, self._wts)]

    # ---------------------------------------------------------- update

    def _add(self, v: float, w: float) -> bool:
        """Add weight ``w`` at ``v``; whether a bin was inserted."""
        vals, gaps = self._vals, self._gaps
        i = bisect.bisect_left(vals, v)
        n = len(vals)
        if i < n and vals[i] == v:
            self._wts[i] += w
            return False
        vals.insert(i, v)
        self._wts.insert(i, w)
        if n:
            if i == 0:
                gaps.insert(0, vals[1] - v)
            elif i == n:
                gaps.append(v - vals[i - 1])
            else:
                gaps[i - 1] = v - vals[i - 1]
                gaps.insert(i, vals[i + 1] - v)
        return True

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if self._add(v, 1.0) and len(self._vals) > self.max_bins:
            self._compact()

    def _compact(self) -> None:
        """Merge the closest adjacent pair (weighted mean), the first of
        equal gaps, until at most ``max_bins`` remain: JAX's loop, the
        gaps kept up to date instead of recomputed."""
        vals, wts, gaps = self._vals, self._wts, self._gaps
        while len(vals) > self.max_bins:
            i = gaps.index(min(gaps))
            wa, wb = wts[i], wts[i + 1]
            w = wa + wb
            merged = (vals[i] * wa + vals[i + 1] * wb) / w
            vals[i] = merged
            wts[i] = w
            del vals[i + 1], wts[i + 1], gaps[i]
            if i > 0:
                gaps[i - 1] = merged - vals[i - 1]
            if i < len(vals) - 1:
                gaps[i] = vals[i + 1] - merged

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bin-wise union, then re-compact).
        Exact aggregates add; returns self for chaining."""
        for v, w in zip(other._vals, other._wts):
            self._add(v, w)
        self._compact()
        self.count += other.count
        self.total += other.total
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    # ----------------------------------------------------------- query

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 when empty. The
        cumulative-weight curve is interpolated between centroids;
        extremes clamp to the exact observed min/max."""
        vals, wts = self._vals, self._wts
        if not vals or self.count == 0:
            return 0.0
        q = max(0.0, min(1.0, q))
        target = q * self.count
        if target <= wts[0] * 0.5:
            return self.min if self.min is not None else vals[0]
        cum = 0.0
        for i, (v, w) in enumerate(zip(vals, wts)):
            mid = cum + w * 0.5
            if target <= mid:
                if i == 0:
                    prev_v = self.min if self.min is not None else v
                    prev_mid = 0.0
                else:
                    prev_v = vals[i - 1]
                    prev_mid = cum - wts[i - 1] * 0.5
                denom = mid - prev_mid
                frac = (target - prev_mid) / denom if denom > 0 else 1.0
                return prev_v + (v - prev_v) * frac
            cum += w
        return self.max if self.max is not None else vals[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total": self.total,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "bins": len(self._vals),
        }


# ---------------------------------------------------------------- table
#
# (pipeline, padded chunk shape) → QuantileSketch of apply-latency
# seconds, plus process throughput/in-flight accounting. Keys are
# strings so the health dict is JSON-ready.

_sketches: Dict[Tuple[str, int], QuantileSketch] = {}
_started: Optional[float] = None
_last_request: Optional[float] = None


def observe_apply(pipeline: str, chunk_shape: int, seconds: float) -> None:
    """Record one live apply latency under its padded ladder shape."""
    key = (str(pipeline), int(chunk_shape))
    now = time.time()
    with _LOCK:
        _observe_apply(key, seconds, now)


def _observe_apply(key: Tuple[str, int], seconds: float, now: float) -> None:
    """`observe_apply` for a caller holding the lock."""
    global _started, _last_request
    sk = _sketches.get(key)
    if sk is None:
        sk = _sketches[key] = QuantileSketch()
    sk.observe(seconds)
    if _started is None:
        _started = now
    _last_request = now


def latency_sketch(pipeline: str, chunk_shape: int) -> Optional[QuantileSketch]:
    with _LOCK:
        return _sketches.get((str(pipeline), int(chunk_shape)))


def reset_live() -> None:
    """Drop all live sketch state (tests; a fresh bench tier)."""
    global _started, _last_request
    with _LOCK:
        _sketches.clear()
        _started = None
        _last_request = None


def health() -> Dict[str, Any]:
    """JSON-ready live-health view: per-(pipeline, shape) latency
    percentiles from the sketches, request totals and throughput, the
    in-flight/queue-depth gauges, breach counters, and — when a
    watchdog is armed — its certificate digest. This is the payload the
    ``--live`` CLI renders and a serving wrapper would export."""
    from .metrics import registry

    with _LOCK:
        rows = [
            {
                "pipeline": pipe,
                "chunk_shape": shape,
                **sk.snapshot(),
            }
            for (pipe, shape), sk in sorted(_sketches.items())
        ]
        started = _started
        last = _last_request
    total = sum(r["count"] for r in rows)
    window = (last - started) if (started is not None and last is not None
                                  and last > started) else 0.0
    reg = registry()
    gauges = {name: g.snapshot() for name, g in sorted(reg.gauges.items())
              if name.startswith(("serving.", "prefetch.", "overlap."))}
    counters = {name: c.snapshot()
                for name, c in sorted(reg.counters.items())
                if name.startswith("serving.")}
    histograms = {name: hg.snapshot()
                  for name, hg in sorted(reg.histograms.items())
                  if name.startswith("serving.")}
    out: Dict[str, Any] = {
        "requests": total,
        "throughput_rps": (total - 1) / window if window > 0 and total > 1
        else 0.0,
        "latency": rows,
        "gauges": gauges,
        "counters": counters,
        "histograms": histograms,
    }
    from .watchdog import active_watchdog

    wd = active_watchdog()
    if wd is not None:
        out["watchdog"] = wd.describe()
    return out


def format_health(h: Dict[str, Any]) -> str:
    """Human rendering of a `health()` dict (the ``--live`` CLI)."""
    lines: List[str] = []
    lines.append(
        f"live telemetry: {int(h.get('requests', 0))} request(s), "
        f"{h.get('throughput_rps', 0.0):.2f} req/s")
    rows = h.get("latency") or []
    if rows:
        lines.append("")
        lines.append(f"{'pipeline':<28} {'shape':>7} {'count':>7} "
                     f"{'p50 ms':>9} {'p90 ms':>9} {'p99 ms':>9} "
                     f"{'max ms':>9}")
        for r in rows:
            lines.append(
                f"{str(r['pipeline'])[:28]:<28} {int(r['chunk_shape']):>7} "
                f"{int(r['count']):>7} {r['p50'] * 1e3:>9.2f} "
                f"{r['p90'] * 1e3:>9.2f} {r['p99'] * 1e3:>9.2f} "
                f"{r['max'] * 1e3:>9.2f}")
    counters = h.get("counters") or {}
    breaches = counters.get("serving.slo_breaches", {}).get("value", 0)
    checked = counters.get("serving.conformance_checks", {}).get("value", 0)
    if checked or breaches:
        lines.append("")
        lines.append(f"conformance: {int(checked)} check(s), "
                     f"{int(breaches)} breach(es)")
    gauges = h.get("gauges") or {}
    inflight = gauges.get("serving.inflight")
    if inflight:
        lines.append(f"in-flight: {int(inflight.get('value', 0))} "
                     f"(peak {int(inflight.get('max', 0))})")
    depth = gauges.get("serving.queue_depth")
    shed = counters.get("serving.shed_total", {}).get("value", 0)
    dispatches = counters.get("serving.dispatches", {}).get("value", 0)
    if depth or shed or dispatches:
        lines.append(
            f"serving runtime: {int(dispatches)} dispatch(es), queue "
            f"depth {int((depth or {}).get('value', 0))} "
            f"(peak {int((depth or {}).get('max', 0))}), "
            f"{int(shed)} shed")
    coalesced = (h.get("histograms") or {}).get("serving.coalesced_batch")
    if coalesced and coalesced.get("count"):
        lines.append(
            f"coalesced batch: mean {coalesced.get('mean', 0.0):.1f} "
            f"p50 {coalesced.get('p50', 0.0):.0f} "
            f"p99 {coalesced.get('p99', 0.0):.0f} "
            f"max {coalesced.get('max', 0.0):.0f} "
            f"(over {int(coalesced['count'])} dispatch(es))")
    wd = h.get("watchdog")
    if wd:
        state = "armed" if wd.get("armed") else "disarmed"
        shapes = wd.get("shapes") or {}
        lines.append("")
        lines.append(
            f"watchdog: {state} [{wd.get('pipeline', '?')}], "
            f"{len(shapes)} certified shape(s), SLO "
            f"{(wd.get('slo_seconds') or 0) * 1e3:.0f}ms")
        for shape in sorted(shapes, key=int):
            lines.append(f"  shape {shape}: bound "
                         f"{shapes[shape] * 1e3:.2f}ms")
    return "\n".join(lines)
