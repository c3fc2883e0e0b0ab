"""The port's live plane on the CPU: the flight recorder
(`telemetry/flight.py`), the streaming sketches (`streaming.py`), the
conformance watchdog and request scope (`watchdog.py`), the kill switch
and ``--live``.

Mirrors `tests/test_live_telemetry.py`; the reconcile join of a
conformance record is in `tests/test_torch_reconcile.py`. Parity: `QuantileSketch` and the metrics `Histogram` give the
JAX package's quantiles on the same observations. `FittedPipeline.apply`
runs under `request_scope`.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu.telemetry import metrics as jax_metrics
from keystone_tpu.telemetry import streaming as jax_streaming
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.stats.normalization import NormalizeRows
from keystone_tpu_torch.telemetry import (
    Tracer,
    flight,
    ledger,
    load_trace,
    metrics,
    set_tracer,
    span,
    streaming,
    summarize,
    to_chrome_trace,
    trace_run,
    watchdog,
)
from keystone_tpu_torch.telemetry.__main__ import main as cli_main
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.env import config_override


@pytest.fixture(autouse=True)
def fresh_plane():
    for reset in (metrics.registry().reset, streaming.reset_live,
                  watchdog.disarm_watchdog, flight.reset_flight,
                  ledger.clear_session):
        reset()
    set_tracer(None)
    yield
    for reset in (metrics.registry().reset, streaming.reset_live,
                  watchdog.disarm_watchdog, flight.reset_flight,
                  ledger.clear_session):
        reset()
    set_tracer(None)
    PipelineEnv.reset()


CERT = {
    "certified": True,
    "slo_seconds": 0.5,
    "shapes": [
        {"batch": 1, "predicted_seconds": 0.1},
        {"batch": 64, "predicted_seconds": 0.2},
        {"batch": 256, "predicted_seconds": 0.3},
    ],
}


def test_ring_is_bounded_and_evicts_oldest():
    ring = flight._Ring(4)
    for i in range(10):
        ring.append(i)
    assert len(ring) == 4 and ring.snapshot() == [6, 7, 8, 9]
    assert ring.dropped == 6


def test_flight_ring_bounded_under_concurrent_emitters(tmp_path):
    """Eight threads emit spans while snapshots run in a loop: the
    capacity holds, nothing is lost from the count, every dump parses
    and holds whole records."""
    rec = flight.ensure_flight()
    cap = rec.capacity
    n_threads, per_thread = 8, 300
    stop = threading.Event()
    dumps = []

    def emit(k):
        for i in range(per_thread):
            rec.record_complete(f"work_{k}", "node", rec.now(), 1e-6, idx=i)

    def snapshotter():
        j = 0
        while True:  # at least one dump, however the threads are run
            out = flight.flight_snapshot(str(tmp_path / f"snap_{j}.json"))
            if out:
                dumps.append(out)
            j += 1
            if stop.is_set():
                break

    snap = threading.Thread(target=snapshotter)
    snap.start()
    workers = [threading.Thread(target=emit, args=(k,))
               for k in range(n_threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    stop.set()
    snap.join(timeout=60)
    assert not snap.is_alive() and not any(w.is_alive() for w in workers)
    assert len(rec.spans) <= cap
    assert len(rec.spans) + rec.spans.dropped == n_threads * per_thread
    assert dumps
    for p in dumps:
        events = [e for e in load_trace(p)["traceEvents"]
                  if e.get("ph") == "X"]
        assert len(events) <= cap + 1
        for e in events:
            assert {"name", "cat", "ts", "dur", "args"} <= set(e)


def test_capacity_from_the_environment(monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_CAPACITY", "16")
    rec = flight.ensure_flight()
    assert rec.capacity == 16
    for i in range(40):
        rec.record_complete("x", "node", rec.now(), 0.0)
    assert len(rec.spans) == 16 and rec.spans.dropped == 24


def test_tee_copies_closed_spans_into_ring():
    rec = flight.ensure_flight()
    with trace_run() as tracer:
        with span("stage_a", "node"):
            pass
    names = [s.name for s in rec.spans]
    assert "stage_a" in names and "pipeline_run" in names
    src = tracer.spans[0]
    assert next(s for s in rec.spans if s.name == src.name) is not src


def test_snapshot_mid_span_roundtrips_through_cli(tmp_path, capsys):
    flight.ensure_flight()
    t = Tracer()
    set_tracer(t)
    open_rec = t.start("megafused_program", "node", plan="p0")
    path = str(tmp_path / "midspan.json")
    out = flight.flight_snapshot(path)
    t.end(open_rec)
    set_tracer(None)
    assert out == path
    trace = load_trace(path)
    mega = [e for e in trace["traceEvents"]
            if e.get("name") == "megafused_program"]
    assert mega and mega[0]["args"]["incomplete"] is True
    assert cli_main([path]) == 0
    assert cli_main(["--flight", path]) == 0
    rendered = capsys.readouterr().out
    assert "megafused_program" in rendered
    assert "in-flight at dump" in rendered


def test_snapshot_lands_in_the_flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    flight.ensure_flight()
    out = flight.flight_snapshot(tag="manual")
    assert out.startswith(str(tmp_path)) and out.endswith("_manual.json")
    assert load_trace(out)["keystone"]["flight"]["capacity"] > 0


def test_atexit_style_flush_emits_open_spans():
    t = Tracer()
    open_rec = t.start("long_apply", "node")
    trace = to_chrome_trace(t)
    t.end(open_rec)
    names = {e["name"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X"}
    assert names["long_apply"]["args"]["incomplete"] is True
    assert "in-flight at dump" in summarize(trace)


def test_watchdog_bound_lookup_covers_ladder():
    wd = watchdog.ConformanceWatchdog.from_certificate(CERT, "p")
    assert wd.bound_for(64) == 0.2
    assert wd.bound_for(1) == 0.1
    assert wd.bound_for(2) == 0.2
    assert wd.bound_for(512) is None
    assert watchdog.ConformanceWatchdog.from_certificate({}, "p") is None


def test_watchdog_breach_counts_dumps_and_ledgers(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    flight.ensure_flight()
    wd = watchdog.arm_watchdog(CERT, pipeline="demo")
    mark = ledger.session_mark()
    assert wd.check(64, 0.05) is False
    assert wd.check(64, 9.0) is True
    assert wd.check(1024, 9.0) is False
    reg = metrics.registry()
    assert reg.counter("serving.slo_breaches").value == 1
    assert reg.counter("serving.conformance_checks").value == 3
    assert reg.counter("serving.uncovered_shapes").value == 1
    (rec,) = [d for d in ledger.session_since(mark)
              if d["kind"] == "conformance"]
    assert rec["predicted"]["bound_seconds"] == pytest.approx(0.2)
    assert rec["chosen"]["observed_seconds"] == pytest.approx(9.0)
    assert rec["chosen"]["flight_dump"]
    assert load_trace(rec["chosen"]["flight_dump"])


def test_request_scope_feeds_sketches_and_watchdog(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    wd = watchdog.arm_watchdog(
        {"shapes": [{"batch": 1, "predicted_seconds": 1e-9}],
         "slo_seconds": 0.001, "certified": True}, pipeline="tight")
    with watchdog.request_scope(1, pipeline="tight"):
        time.sleep(0.002)
    assert wd.checked == 1 and wd.breaches == 1
    assert metrics.registry().counter("serving.requests").value == 1
    assert streaming.latency_sketch("tight", 1).count == 1
    rec = flight.flight_recorder()
    assert any(s.name == "apply_request" for s in rec.spans)
    h = streaming.health()
    assert h["requests"] == 1 and h["watchdog"]["breaches"] == 1
    rendered = streaming.format_health(h)
    assert "tight" in rendered and "breach" in rendered


def test_request_scope_keys_by_the_padded_shape():
    with config_override(chunk_size=64):
        for batch, shape in ((3, 4), (64, 64), (100, 64)):
            with watchdog.request_scope(batch, pipeline="p") as got:
                assert got == shape


def test_fitted_apply_is_one_request():
    """Each `FittedPipeline.apply` runs under `request_scope`: one
    request a call, keyed by its padded shape, and no request at all
    with the live plane off."""
    rng = np.random.default_rng(0)
    X = Dataset(np.abs(rng.normal(size=(50, 6))).astype(np.float32) + 0.1,
                device="cpu")
    fitted = NormalizeRows().to_pipeline().fit()
    for _ in range(3):
        fitted.apply(X)
    fitted.apply(torch.ones(6))
    reg = metrics.registry()
    assert reg.counter("serving.requests").value == 4
    assert streaming.latency_sketch("fitted_pipeline", 64).count == 3
    assert streaming.latency_sketch("fitted_pipeline", 1).count == 1
    assert reg.histogram("serving.apply_seconds").count == 4
    with config_override(live_telemetry=False):
        fitted.apply(X)
    assert reg.counter("serving.requests").value == 4


def test_sketch_fixed_memory_and_accuracy():
    sk = streaming.QuantileSketch(max_bins=64)
    for i in range(50_000):
        sk.observe((i % 1000) / 1000.0)
    assert len(sk._bins) <= 64 and sk.count == 50_000
    assert sk.quantile(0.5) == pytest.approx(0.5, abs=0.05)
    assert sk.quantile(0.99) == pytest.approx(0.99, abs=0.05)


def test_sketch_merge():
    a, b = streaming.QuantileSketch(), streaming.QuantileSketch()
    for i in range(1000):
        a.observe(i / 1000.0)
        b.observe(1.0 + i / 1000.0)
    a.merge(b)
    assert a.count == 2000 and len(a._bins) <= a.max_bins
    assert a.quantile(0.5) == pytest.approx(1.0, abs=0.1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_and_histogram_quantiles_equal_jax_s(seed):
    rng = np.random.default_rng(seed)
    obs = np.concatenate([rng.lognormal(-6, 0.5, 4000),
                          rng.uniform(0, 0.01, 500)]).tolist()
    ours, theirs = streaming.QuantileSketch(), jax_streaming.QuantileSketch()
    hist, jhist = metrics.Histogram("h"), jax_metrics.Histogram("h")
    for v in obs:
        ours.observe(v)
        theirs.observe(v)
        hist.observe(v)
        jhist.observe(v)
    assert ours.snapshot() == theirs.snapshot()
    assert hist.snapshot() == jhist.snapshot()
    half = len(obs) // 2
    a, b = streaming.QuantileSketch(), streaming.QuantileSketch()
    ja, jb = jax_streaming.QuantileSketch(), jax_streaming.QuantileSketch()
    for v in obs[:half]:
        a.observe(v)
        ja.observe(v)
    for v in obs[half:]:
        b.observe(v)
        jb.observe(v)
    assert a.merge(b).snapshot() == ja.merge(jb).snapshot()


def test_histogram_reservoir_bounded_with_percentiles():
    h = metrics.histogram("t.reservoir")
    for i in range(10_000):
        h.observe(i / 10_000.0)
    assert len(h._reservoir) == metrics.RESERVOIR_SIZE
    snap = h.snapshot()
    assert snap["count"] == 10_000
    assert snap["p50"] == pytest.approx(0.5, abs=0.08)


def test_kill_switch_disables_the_whole_plane():
    with config_override(live_telemetry=False):
        assert flight.ensure_flight() is None
        assert flight.flight_snapshot() is None
        assert watchdog.arm_watchdog(CERT, pipeline="off") is None
        with watchdog.request_scope(64, pipeline="off") as shape:
            assert shape is None
    assert metrics.registry().counter("serving.requests").value == 0
    assert streaming.health()["requests"] == 0
    assert flight.flight_recorder() is None


def test_live_config_field_in_ledger_header():
    header = ledger.run_header()
    assert "live_telemetry" in header["config"]
    assert ledger.CONFIG_ENV["live_telemetry"] == "KEYSTONE_LIVE_TELEMETRY"
    assert "conformance" in ledger.KINDS


def test_cli_live_renders_health(capsys):
    streaming.observe_apply("demo", 64, 0.01)
    assert cli_main(["--live"]) == 0
    out = capsys.readouterr().out
    assert "demo" in out and "p99" in out
    assert cli_main(["--live", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["latency"][0]["pipeline"] == "demo"
