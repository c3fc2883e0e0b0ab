"""Chrome trace-event JSON export and trace summarization.

Counterpart of `keystone_tpu/telemetry/export.py:1-402`, with JAX's
format. The export is the Trace Event Format's object form: a
``traceEvents`` list of complete (``"ph": "X"``) events plus counter
(``"ph": "C"``) samples, loadable in ``chrome://tracing`` or Perfetto
unchanged. Keystone extras ride in a top-level ``"keystone"`` object
Chrome ignores: the metrics-registry snapshot, the capability probes
(the card among them) and the decision ledger's records.

Span hierarchy survives the export: every event's ``args`` carries
``span_id`` and (when nested) ``parent_id``, so summaries can compute
*self* time, a span's duration minus its direct children's.

`summarize` ends with JAX's three joins (`:349-390`), each through
`analysis/reconcile.py`: the static memory estimates against the node
spans' bytes, the roofline's predicted seconds against their seconds,
and the serving certificate's bounds against measured percentiles.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .metrics import registry
from .spans import Tracer, capabilities


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Render ``tracer`` (+ the current metrics registry and capability
    probes) as a Chrome trace object."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "keystone_tpu_torch"},
    }]
    now = tracer.now()
    closed = list(tracer.spans)  # snapshot: appends may race the export
    seen = {id(s) for s in closed}
    # In-flight spans export as complete events running to "now", marked
    # ``args.incomplete`` — a dump racing an open span (flight snapshot,
    # atexit flush mid-run) stays fully parseable instead of silently
    # dropping the span that was on the CPU when the dump fired.
    open_spans = [s for s in tracer.open_spans() if id(s) not in seen]
    for s, incomplete in ([(s, False) for s in closed]
                          + [(s, True) for s in open_spans]):
        args = dict(s.args)
        args["span_id"] = s.sid
        if s.parent is not None:
            args["parent_id"] = s.parent
        if s.error:
            args["error"] = True
        dur = s.dur
        if incomplete:
            args["incomplete"] = True
            dur = max(0.0, now - s.t0)
        events.append({
            "name": s.name,
            "cat": s.cat,
            "ph": "X",
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": pid,
            "tid": s.tid,
            "args": args,
        })
    for name, t, value, tid in list(tracer.counter_samples):
        events.append({
            "name": name,
            "ph": "C",
            "ts": round(t * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": {"value": value},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "keystone": {
            "wall_epoch": tracer.wall_epoch,
            "metrics": registry().snapshot(),
            "capabilities": capabilities(),
            **tracer.metadata,
        },
    }


def write_trace(tracer: Tracer, path: str) -> str:
    trace = to_chrome_trace(tracer)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)  # atomic: a killed process never leaves half a trace
    return path


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError(f"{path} is not a Chrome trace object (no traceEvents)")
    return trace


# ------------------------------------------------------------- summaries


def _complete_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def self_times(trace: Dict[str, Any]) -> Dict[int, float]:
    """span_id → self-time µs (duration minus direct children)."""
    events = _complete_events(trace)
    child_dur: Dict[int, float] = {}
    for e in events:
        parent = e.get("args", {}).get("parent_id")
        if parent is not None:
            child_dur[parent] = child_dur.get(parent, 0.0) + e.get("dur", 0.0)
    out: Dict[int, float] = {}
    for e in events:
        sid = e.get("args", {}).get("span_id")
        if sid is not None:
            out[sid] = max(0.0, e.get("dur", 0.0) - child_dur.get(sid, 0.0))
    return out


def aggregate_spans(
    trace: Dict[str, Any], cat: Optional[str] = None
) -> Dict[str, Dict[str, float]]:
    """name → {count, total_s, self_s, bytes} over complete events,
    optionally restricted to one category."""
    selfs = self_times(trace)
    agg: Dict[str, Dict[str, float]] = {}
    for e in _complete_events(trace):
        if cat is not None and e.get("cat") != cat:
            continue
        a = agg.setdefault(e["name"], {
            "count": 0, "total_s": 0.0, "self_s": 0.0, "bytes": 0.0,
        })
        a["count"] += 1
        a["total_s"] += e.get("dur", 0.0) / 1e6
        sid = e.get("args", {}).get("span_id")
        a["self_s"] += selfs.get(sid, e.get("dur", 0.0)) / 1e6
        a["bytes"] += float(e.get("args", {}).get("out_bytes", 0.0) or 0.0)
    return agg


def _per_process_counts(counters: Dict[str, Any], base: str) -> str:
    """``" ; per-process: p0=12 p1=11"`` when the trace carries a
    multi-host breakdown of ``base`` (the JAX package's ``<base>.p<i>``
    counters), empty otherwise."""
    prefix = base + ".p"
    rows = [(name[len(base) + 1:], v.get("value", 0))
            for name, v in counters.items() if name.startswith(prefix)]
    if not rows:
        return ""

    def idx(dim: str):
        # numeric process order (p10 after p2, not lexicographic)
        try:
            return (0, int(dim[1:]))
        except ValueError:
            return (1, 0)

    rows.sort(key=lambda r: (idx(r[0]), r[0]))
    return " ; per-process: " + " ".join(
        f"{dim}={int(v)}" for dim, v in rows)


def dispatch_summary(trace: Dict[str, Any]) -> Optional[str]:
    """One-line per-run dispatch digest from a trace's metrics snapshot
    (programs executed, node forces, concurrent-scheduler activity —
    plus the per-process program counts when the trace came from a
    multi-host mesh), or None when the trace predates the dispatch
    counters. Read by the trace CLI."""
    counters = trace.get("keystone", {}).get("metrics", {}).get("counters", {})
    programs = counters.get("dispatch.programs_executed", {}).get("value")
    if not programs:
        return None
    sched = counters.get("dispatch.scheduler_runs", {}).get("value", 0)
    tasks = counters.get("dispatch.scheduled_tasks", {}).get("value", 0)
    forces = counters.get("executor.node_forces", {}).get("value", 0)
    line = (f"programs executed: {int(programs)} "
            f"(node forces {int(forces)}; concurrent scheduler ran "
            f"{int(sched)}x over {int(tasks)} task(s))")
    mega = counters.get("megafusion.programs", {}).get("value", 0)
    if mega:
        trips = counters.get("megafusion.scan_trips", {}).get("value", 0)
        line += (f"; megafused: {int(mega)} program(s), "
                 f"{int(trips)} in-program scan trip(s)")
    line += _per_process_counts(counters, "dispatch.programs_executed")
    return line


def dispatch_plan_breakdown(trace: Dict[str, Any]) -> List[str]:
    """Per-plan apply-run program rows from the trace metadata the
    dispatch bench embeds (``keystone.dispatch_plans``): one line per
    example, ``serial_unfused/legacy/optimized/megafused`` columns, as
    the JAX package's dispatch bench writes them. Empty when the trace
    carries none (the port has no such bench yet)."""
    plans_meta = trace.get("keystone", {}).get("dispatch_plans") or {}
    per_example = plans_meta.get("apply_run_programs") or {}
    plans = plans_meta.get("plans") or []
    lines = []
    for example in sorted(per_example):
        row = per_example[example]
        cols = " ".join(
            f"{p}={row[p]}" for p in (plans or sorted(row)) if p in row)
        lines.append(f"apply programs/run [{example}]: {cols}")
    return lines


def compile_summary(trace: Dict[str, Any]) -> Optional[str]:
    """One-line compile digest from a trace's metrics snapshot: cold
    compiles vs persistent-cache hits and their wall-clock totals, or
    None when the trace predates compile accounting. The accounting
    layer pre-registers its counters when the hooks install
    (`compile_events.install_compile_listeners`), so a fully warm run's
    "0 cold" reports instead of vanishing — that zero IS the headline
    number. Read by the trace CLI."""
    metrics = trace.get("keystone", {}).get("metrics", {})
    counters = metrics.get("counters", {})
    hists = metrics.get("histograms", {})
    if ("dispatch.programs_compiled" not in counters
            and "dispatch.compile_cache_hits" not in counters):
        return None  # pre-accounting trace
    cold_n = int(counters.get(
        "dispatch.programs_compiled", {}).get("value", 0))
    hits = int(counters.get(
        "dispatch.compile_cache_hits", {}).get("value", 0))
    cold_s = hists.get("compile.cold_secs", {}).get("total", 0.0)
    warm_s = hists.get("compile.warm_secs", {}).get("total", 0.0)
    return (f"programs compiled: {cold_n} cold ({cold_s:.3f}s) + "
            f"{hits} cache hit(s) ({warm_s:.3f}s retrieval)"
            + _per_process_counts(counters, "dispatch.programs_compiled"))


def decision_summary(trace: Dict[str, Any]) -> Optional[str]:
    """One-line digest of the optimizer decisions embedded in the trace
    metadata (`telemetry.ledger.record_decision` appends them under
    ``keystone.decisions``): per-kind counts plus the predicted savings
    totals, ending with the CLI pointer that renders the full
    per-decision table. None when the trace carries no decisions."""
    decisions = trace.get("keystone", {}).get("decisions") or []
    if not decisions:
        return None
    from .ledger import decision_key

    # dedup by (kind, labels): each optimizer invocation (fit graph,
    # apply graph, plan sweeps) re-records the same decision — counting
    # raw records would inflate the digest vs reconcile_decisions
    unique: Dict = {}
    for d in decisions:
        unique.setdefault(decision_key(d), d)
    kinds: Dict[str, int] = {}
    bytes_saved = 0
    for d in unique.values():
        k = str(d.get("kind"))
        kinds[k] = kinds.get(k, 0) + 1
        pred = d.get("predicted") or {}
        for key in ("boundary_bytes_saved", "policy_bytes_saved"):
            v = pred.get(key)
            if isinstance(v, (int, float)):
                bytes_saved += int(v)
    parts = [f"{kinds[k]} {k}" for k in sorted(kinds)]
    line = (f"optimizer decisions: {len(unique)} distinct "
            f"({', '.join(parts)}; {len(decisions)} record(s))")
    if bytes_saved:
        line += f", {_fmt_bytes(bytes_saved)} predicted saved"
    return line + " — `--ledger` renders the per-decision table"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:,.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024
    return f"{n}B"


def summarize(trace: Dict[str, Any], top: int = 15) -> str:
    """Human-readable trace digest: top spans by self-time per category,
    prefetch stall totals, bytes moved, and (when the trace carries the
    analyzer's static estimates) the static-vs-observed memory
    reconciliation table."""
    lines: List[str] = []
    events = _complete_events(trace)
    n_events = len(events)
    n_open = sum(1 for e in events
                 if e.get("args", {}).get("incomplete"))
    open_note = f" ({n_open} in-flight at dump)" if n_open else ""
    lines.append(f"{n_events} span(s){open_note}")

    for cat, title in (("node", "top node forces by self-time"),
                       ("step", "solver iterations"),
                       ("chunk", "stream chunks")):
        agg = aggregate_spans(trace, cat)
        if not agg:
            continue
        lines.append(f"\n== {title} ==")
        lines.append(f"{'name':<44} {'self s':>9} {'total s':>9} "
                     f"{'count':>6} {'bytes':>12}")
        rows = sorted(agg.items(), key=lambda kv: -kv[1]["self_s"])
        for name, a in rows[:top]:
            lines.append(
                f"{name[:44]:<44} {a['self_s']:>9.4f} {a['total_s']:>9.4f} "
                f"{int(a['count']):>6} {_fmt_bytes(a['bytes']):>12}"
            )

    ks = trace.get("keystone", {})
    hist = ks.get("metrics", {}).get("histograms", {})
    stall = hist.get("prefetch.producer_stall_s")
    wait = hist.get("prefetch.consumer_wait_s")
    if stall or wait:
        lines.append("\n== overlap queue stalls ==")
        if stall:
            lines.append(
                f"producer stall: {stall['total']:.4f}s total over "
                f"{int(stall['count'])} put(s) (max {stall['max']:.4f}s)")
        if wait:
            lines.append(
                f"consumer wait:  {wait['total']:.4f}s total over "
                f"{int(wait['count'])} get(s) (max {wait['max']:.4f}s)")
    counters = ks.get("metrics", {}).get("counters", {})
    dispatch = dispatch_summary(trace)
    compiles = compile_summary(trace)
    breakdown = dispatch_plan_breakdown(trace)
    if dispatch or compiles or breakdown:
        lines.append("\n== dispatch ==")
        if dispatch:
            lines.append(dispatch)
        lines.extend(breakdown)
        if compiles:
            lines.append(compiles)
    decisions = decision_summary(trace)
    if decisions:
        lines.append("\n== decisions ==")
        lines.append(decisions)
    moved = counters.get("overlap.bytes_pulled", {}).get("value")
    if moved:
        lines.append(f"\nbytes pulled off device: {_fmt_bytes(moved)}")
    live = ks.get("observed_live_peak_bytes") or (
        ks.get("metrics", {}).get("gauges", {})
        .get("executor.live_bytes", {}).get("max"))
    if live:
        lines.append(f"observed peak live set: {_fmt_bytes(live)}")

    try:
        from ..analysis.reconcile import format_reconciliation, reconcile_trace

        rec = reconcile_trace(trace)
        if rec["rows"]:
            lines.append("")
            lines.append(format_reconciliation(rec))
    except Exception as e:  # a malformed trace must still summarize
        lines.append(f"\n(memory reconciliation unavailable: {e})")

    try:
        from ..analysis.reconcile import reconcile_roofline

        roof = reconcile_roofline(trace)
        if roof["stages_joined"]:
            lines.append(
                "\n== roofline (predicted vs observed seconds) ==")
            lines.append(
                f"{roof['stages_joined']} stage(s) joined: predicted "
                f"{roof['predicted_seconds']:.4f}s, observed "
                f"{roof['observed_seconds']:.4f}s, flops residual "
                f"{roof['flops_residual_seconds']:+.4f}s")
    except Exception:
        pass  # advisory: partial traces summarize without it

    try:
        from ..analysis.reconcile import (
            format_serving_reconciliation,
            reconcile_serving,
        )

        serving = reconcile_serving(trace)
        if serving["rows"]:
            lines.append("")
            lines.append(format_serving_reconciliation(serving))
        elif ks.get("serving"):
            cert = ks["serving"]
            verdict = "certified" if cert.get("certified") else "UNCERTIFIED"
            lines.append(
                f"\nserving certificate: {verdict}, "
                f"{len(cert.get('shapes', []))} ladder shape(s), SLO "
                f"{(cert.get('slo_seconds') or 0) * 1e3:.0f}ms (no "
                "observed percentiles: a serving run's per-rung "
                "keystone.serving_observed joins them)")
    except Exception:
        pass  # advisory: partial traces summarize without it

    caps = ks.get("capabilities") or {}
    absent = {k: v for k, v in caps.items() if not v.get("available", True)}
    if absent:
        lines.append("\n== absent capabilities ==")
        for name, v in sorted(absent.items()):
            reason = v.get("reason", "")
            lines.append(f"{name}: {reason}" if reason else name)
    return "\n".join(lines)
