"""Runtime telemetry: hierarchical spans, a process-wide metrics
registry, Chrome trace export, the decision ledger, the flight recorder
and the live request plane.

Counterpart of `keystone_tpu/telemetry/` (`__init__.py:1-101`), with
JAX's metric names, span categories, file formats and environment
variables, so a trace or ledger written by either package reads the
same through either CLI. Span hierarchy (structural, per-thread stacks):

    pipeline run → optimizer phase → node force → stream chunk
                                                → solver step
                                                → graph replay

Quick start:

    from keystone_tpu_torch.telemetry import trace_run
    with trace_run("run.json"):
        pipeline(data).get()

    KEYSTONE_TRACE=run.json python -m keystone_tpu_torch MnistRandomFFT
    python -m keystone_tpu_torch.telemetry run.json

Environment: ``KEYSTONE_TRACE`` (trace written at exit),
``KEYSTONE_LEDGER`` (decision JSONL), ``KEYSTONE_LIVE_TELEMETRY``
(the flight recorder and request scope; default on),
``KEYSTONE_FLIGHT_CAPACITY``, ``KEYSTONE_FLIGHT_DIR``.

The port's metrics, with their sources:

  executor.node_forces / node_failures      instrument.instrument_node_force
  executor.memo_hits / prefix_saves         workflow/executor.py (traced
                                            or profiled runs)
  executor.live_bytes (gauge)               instrument
  executor.prefix_reuse                     workflow/optimizer.py (a saved
                                            fit or cache swapped in)
  dispatch.programs_executed                instrument.record_dispatch: a
                                            `Dataset.map_batches` call, a
                                            host stream unit, a solver step
                                            (BCD, L-BFGS, KRR), the
                                            node-level batched calls
                                            (patchers, windower, scaler and
                                            linear fits); nothing inside a
                                            graph capture or a warm-up
  dispatch.scheduler_runs / scheduled_tasks workflow/executor.py scheduler
  dispatch.warmup_failures                  workflow/executor.py warm-ups
  dispatch.programs_compiled / compile_cache_hits,
  compile.cold_secs / warm_secs             compile_events: `ops/_build.py`
                                            builds and loads, graph
                                            captures
  megafusion.programs / scan_trips          nodes/util/fusion.py: padded
                                            loops run, trips they ran
  megafusion.graph_captures / graph_replays nodes/util/fusion.py
  prefetch.queue_depth (gauge),
  prefetch.producer_stall_s / consumer_wait_s  utils/batching.py
  overlap.chunks_dispatched,
  overlap.inflight_results / resident_chunks (gauges),
  overlap.peak_pinned_bytes (gauge)         utils/batching.py host stream
  solver.steps                              block_ls (BCD), lbfgs, kernels
                                            (KRR)
  serving.requests / inflight / apply_seconds,
  serving.conformance_checks / slo_breaches /
  uncovered_shapes                          watchdog.request_scope

The JAX package's ``overlap.bytes_pulled`` has no counterpart (the
port's results stay on the card), nor have its spill, planner and
serving-runtime metrics (ROADMAP queue 1, items 7, 8 and 10). The
kernels' own launch counts (``<wrapper>.launches``, `ops/kernels.py`)
stay beside these: `chip_smoke.py` reads them.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsDelta,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    metrics_delta,
    registry,
)
from . import ledger
from .spans import (
    SpanRecord,
    Tracer,
    capabilities,
    current_tracer,
    record_capability,
    set_tracer,
    span,
    telemetry_active,
    trace_run,
)
from .export import (
    aggregate_spans,
    compile_summary,
    dispatch_plan_breakdown,
    dispatch_summary,
    load_trace,
    self_times,
    summarize,
    to_chrome_trace,
    write_trace,
)
from .instrument import estimate_bytes, instrument_node_force, record_dispatch
from .compile_events import compiles_snapshot, record_compile
from .flight import (
    FlightRecorder,
    ensure_flight,
    flight_recorder,
    flight_snapshot,
    reset_flight,
)
from .streaming import QuantileSketch, format_health, health, reset_live
from .watchdog import (
    ConformanceWatchdog,
    active_watchdog,
    arm_watchdog,
    disarm_watchdog,
    request_scope,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsDelta", "MetricsRegistry",
    "counter", "gauge", "histogram", "ledger", "metrics_delta",
    "registry",
    "SpanRecord", "Tracer", "capabilities", "current_tracer",
    "record_capability", "set_tracer", "span", "telemetry_active",
    "trace_run",
    "aggregate_spans", "compile_summary", "dispatch_plan_breakdown",
    "dispatch_summary", "load_trace", "self_times",
    "summarize", "to_chrome_trace", "write_trace",
    "estimate_bytes", "instrument_node_force", "record_dispatch",
    "compiles_snapshot", "record_compile",
    "FlightRecorder", "ensure_flight", "flight_recorder",
    "flight_snapshot", "reset_flight",
    "QuantileSketch", "format_health", "health", "reset_live",
    "ConformanceWatchdog", "active_watchdog", "arm_watchdog",
    "disarm_watchdog", "request_scope",
]
