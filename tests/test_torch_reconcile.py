"""`keystone_tpu_torch/analysis/reconcile.py` and its telemetry joins on
the CPU, held against `keystone_tpu/analysis/reconcile.py`.

Parity: for the same trace and run dicts every function of the port's
`reconcile.py` and every formatter returns what JAX's returns, with no
tolerance: over a traced apply run written by each package, over a
traced fit-and-apply run, over the kernel plan's LinearPixels run (JAX's
holds its ``chain_kernel`` spans; on the CPU the port's holds none, since
its K4 does not launch there), and over a synthetic run holding every decision
kind (fusion, megafusion, placement, precision, kernel, spill,
conformance). `cost_model_drift` reads the cost weights, which differ
between the packages on the CPU (the port's are the CPU's analytic
rates), so its parity cases price the port with JAX's weights.

Mirrors, on the port's own runs: `tests/test_ledger.py:280-467` (the
exactness pins of a traced apply, the warm re-apply's zero compiles,
``--diff`` against megafusion off, the drift report),
`tests/test_telemetry.py:191-215` (the summary's memory reconciliation),
`tests/test_live_telemetry.py:226` (the conformance record's join),
`tests/test_serving.py:413-470` (the serving join),
`tests/test_roofline.py:327-470` (`chain_predicted_seconds`, the
roofline join, the drift with roofline, the fusion decisions' predicted
seconds) and `tests/test_precision.py:401-430` (uint8 bytes exact). The
JAX side runs on a one-device mesh (ROADMAP, ground rules).
"""

import json

import numpy as np
import pytest
import torch

import jax

from keystone_tpu import dispatch_bench as jax_bench
from keystone_tpu.analysis import reconcile as jax_rec
from keystone_tpu.nodes.learning import cost_model as jax_cost_model
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.telemetry import ledger as jax_ledger
from keystone_tpu.telemetry import registry as jax_registry
from keystone_tpu.telemetry import trace_run as jax_trace_run
from keystone_tpu.workflow import PipelineEnv as JaxPipelineEnv
from keystone_tpu.workflow import env as jax_env
from keystone_tpu.workflow.executor import drain_warmups as jax_drain
from keystone_tpu_torch import dispatch_bench as bench
from keystone_tpu_torch.analysis import reconcile as rec
from keystone_tpu_torch.analysis.roofline import chain_predicted_seconds
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import cost_model
from keystone_tpu_torch.nodes.learning.calibrate import CostWeights
from keystone_tpu_torch.telemetry import (
    flight,
    ledger,
    load_trace,
    registry,
    summarize,
    to_chrome_trace,
    trace_run,
    watchdog,
)
from keystone_tpu_torch.telemetry.__main__ import main as telemetry_main
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.env import (
    config_override,
    dispatch_override,
    overlap_override,
)
from keystone_tpu_torch.workflow.executor import drain_warmups

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    PipelineEnv.reset()
    ledger.clear_session()
    yield
    PipelineEnv.reset()
    ledger.clear_session()
    watchdog.disarm_watchdog()
    flight.reset_flight()


@pytest.fixture
def jax_weights(monkeypatch):
    """The port priced with JAX's CPU cost weights."""
    weights = (float(jax_cost_model.CPU_WEIGHT),
               float(jax_cost_model.MEM_WEIGHT),
               float(jax_cost_model.NETWORK_WEIGHT))
    monkeypatch.setattr(cost_model, "resolve_weights", lambda: weights)
    return weights


# ------------------------------------------------------------ traced runs


def _port_run(path, name="MnistRandomFFT", plan="megafused", warm=False,
              fit_in_trace=False):
    """``name`` fit outside the window (unless ``fit_in_trace``), then
    one apply run traced with a fresh registry: the run-exact shape
    `reconcile_decisions` documents. ``warm`` applies once before."""
    optimizer, overlap_on, concurrent_on, overrides = bench._plan_context(
        plan)
    PipelineEnv.reset()
    try:
        PipelineEnv.get().set_optimizer(optimizer)
        with overlap_override(overlap_on), dispatch_override(concurrent_on), \
                config_override(**overrides):
            predictor, train, test = bench.EXAMPLES[name](CPU)
            if fit_in_trace:
                with trace_run(path):
                    predictor(train).get()
                    out = predictor(test).get().numpy()
                return out
            predictor(train).get()
            if warm:
                predictor(test).get()
            drain_warmups()
            ledger.clear_session()
            registry().reset()
            with trace_run(path):
                out = predictor(test).get().numpy()
                drain_warmups()
    finally:
        PipelineEnv.reset()
    return out


def _jax_run(path, name="MnistRandomFFT", plan="megafused",
             fit_in_trace=False):
    optimizer, overlap_on, concurrent_on, overrides = \
        jax_bench._plan_context(plan)
    kernel_env = (jax_bench._chain_kernel_interpret() if plan == "kernel"
                  else __import__("contextlib").nullcontext())
    JaxPipelineEnv.reset()
    try:
        with use_mesh(make_mesh(jax.devices()[:1])), kernel_env:
            JaxPipelineEnv.get().set_optimizer(optimizer)
            with jax_env.overlap_override(overlap_on), \
                    jax_env.dispatch_override(concurrent_on), \
                    jax_env.config_override(**overrides):
                predictor, train, test = jax_bench.EXAMPLES[name]()
                if fit_in_trace:
                    with jax_trace_run(path):
                        predictor(train).get()
                        out = np.asarray(predictor(test).get().numpy())
                    return out
                predictor(train).get()
                jax_drain()
                jax_ledger.clear_session()
                jax_registry().reset()
                with jax_trace_run(path):
                    out = np.asarray(predictor(test).get().numpy())
                    jax_drain()
    finally:
        JaxPipelineEnv.reset()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Trace paths: each package's traced apply and fit-and-apply runs of
    MnistRandomFFT, and each package's kernel-plan LinearPixels apply."""
    d = tmp_path_factory.mktemp("reconcile")
    out = {}
    for key, kwargs in (("apply", {}), ("fit", dict(fit_in_trace=True)),
                        ("kernel", dict(name="LinearPixels", plan="kernel",
                                        fit_in_trace=True))):
        out["port_" + key] = str(d / f"port_{key}.json")
        _port_run(out["port_" + key], **kwargs)
        ledger.clear_session()
        out["jax_" + key] = str(d / f"jax_{key}.json")
        _jax_run(out["jax_" + key], **kwargs)
        jax_ledger.clear_session()
    PipelineEnv.reset()
    return out


def _synthetic_run():
    """One run holding every decision kind, its spans and counters."""
    events = [
        {"ph": "X", "cat": "node", "name": "force Fused[A >> B]", "dur": 40,
         "args": {"vertex": 2, "out_bytes": 4096, "seconds": 4e-5}},
        {"ph": "X", "cat": "node", "name": "force Cast[bf16]", "dur": 10,
         "args": {"vertex": 3, "out_bytes": 1024, "seconds": 1e-5}},
        {"ph": "X", "cat": "node", "name": "megafused_program", "dur": 90,
         "args": {"scan_trips": 3}},
        {"ph": "X", "cat": "node", "name": "chain_kernel", "dur": 25,
         "args": {"label": "Fused[A >> B]", "family": "elementwise",
                  "predicted_seconds": 3e-5, "statically_verified": None}},
        {"ph": "X", "cat": "spill", "name": "spill_window", "dur": 5,
         "args": {}},
        {"ph": "X", "cat": "request", "name": "apply_request", "dur": 9000,
         "args": {"chunk_shape": 64}},
    ]
    trace = {"traceEvents": events, "keystone": {
        "static_memory": {"per_node": {
            "2:Fused[A >> B]": {"label": "Fused[A >> B]", "vertex": 2,
                                "bytes": 8192, "dtype": "float32"},
            "7:Other": {"label": "Other", "vertex": 7, "bytes": 10}},
            "peak_bytes": 9000},
        "observed_live_peak_bytes": 6000,
        "roofline": {"per_node": {
            "2:Fused[A >> B]": {"label": "Fused[A >> B]", "vertex": 2,
                                "flops": 1e6, "bound": "bandwidth",
                                "predicted_seconds": 2e-5}},
            "peak_flops": 5e10, "peak_bw": 2e10},
        "serving": {"shapes": [{"batch": 64, "predicted_seconds": 0.2,
                                "machine_seconds": 1e-3}],
                    "slo_seconds": 0.5, "certified": True,
                    "dominating_stage": "Fused[A >> B]"},
        "serving_observed": [{"batch": 64, "chunk_shape": 64,
                              "p50_ms": 3.0, "p99_ms": 7.5}],
        "metrics": {
            "counters": {"dispatch.programs_executed": {"value": 2},
                         "dispatch.programs_compiled": {"value": 1},
                         "megafusion.programs": {"value": 1},
                         "precision.casts_baked": {"value": 2},
                         "spill.bytes_out": {"value": 512},
                         "spill.bytes_in": {"value": 512}},
            "histograms": {"spill.reload_stall_s": {"count": 2,
                                                    "total": 0.004}},
            "gauges": {}},
    }}

    def dec(seq, kind, labels, chosen=None, predicted=None):
        return {"seq": seq, "kind": kind, "labels": labels,
                "chosen": chosen or {}, "predicted": predicted or {},
                "alternatives": [], "enforced": True}

    decisions = [
        dec(0, "fusion", ["Fused[A >> B]"], {"programs": 1},
            {"programs_per_apply": 1, "cold_compiles_max": 1}),
        dec(1, "megafusion", ["Megafused"], {"programs": 1},
            {"programs_per_apply": 1, "cold_compiles_max": 1}),
        dec(2, "placement", ["Cast"], {}, {"boundary_bytes": 2000,
                                           "boundary_bytes_saved": 64}),
        dec(3, "precision", ["Cast"], {}, {"casts_baked": 2,
                                           "policy_bytes_saved": 128}),
        dec(4, "kernel", ["Fused[A >> B]"],
            {"kernels": [{"kernel_seconds": 3e-5}]}),
        dec(5, "spill", ["Cacher"], {}, {"reload_seconds": 0.01}),
        dec(6, "conformance", ["demo"], {"chunk_shape": 64},
            {"bound_seconds": 0.2}),
        dec(7, "fusion", ["Fused[A >> B]"], {"programs": 1},
            {"programs_per_apply": 1, "cold_compiles_max": 1}),
    ]
    return {"trace": trace, "decisions": decisions, "header": {}}


# ----------------------------------------------------------------- parity


_TRACE_FUNCTIONS = ("observed_node_bytes", "reconcile_trace",
                    "observed_node_seconds", "reconcile_roofline",
                    "reconcile_serving", "cost_model_drift")


def _both(fn_name, *args):
    return (getattr(rec, fn_name)(*args), getattr(jax_rec, fn_name)(*args))


@pytest.mark.parametrize("fn_name", _TRACE_FUNCTIONS)
@pytest.mark.parametrize("source", ["port_apply", "jax_apply", "port_fit",
                                    "jax_fit", "port_kernel", "jax_kernel",
                                    "synthetic"])
def test_trace_functions_equal_jax(source, fn_name, runs, jax_weights):
    trace = (_synthetic_run()["trace"] if source == "synthetic"
             else load_trace(runs[source]))
    got, want = _both(fn_name, trace)
    assert got == want


@pytest.mark.parametrize("source", ["port_apply", "jax_apply", "port_fit",
                                    "jax_fit", "port_kernel", "jax_kernel",
                                    "synthetic"])
def test_decisions_and_formatters_equal_jax(source, runs, jax_weights):
    run = (_synthetic_run() if source == "synthetic"
           else ledger.read_ledger(runs[source]))
    got, want = _both("reconcile_decisions", run)
    assert got == want
    assert rec.format_decision_reconciliation(got) == \
        jax_rec.format_decision_reconciliation(want)
    trace = run["trace"]
    assert rec.format_reconciliation(rec.reconcile_trace(trace)) == \
        jax_rec.format_reconciliation(jax_rec.reconcile_trace(trace))
    assert rec.format_drift(rec.cost_model_drift(trace)) == \
        jax_rec.format_drift(jax_rec.cost_model_drift(trace))
    assert rec.format_serving_reconciliation(rec.reconcile_serving(trace)) \
        == jax_rec.format_serving_reconciliation(
            jax_rec.reconcile_serving(trace))
    got_w = rec.drift_cost_weights(trace)
    want_w = jax_rec.drift_cost_weights(trace)
    assert isinstance(got_w, CostWeights)
    assert (got_w.cpu_weight, got_w.mem_weight, got_w.network_weight) == (
        want_w.cpu_weight, want_w.mem_weight, want_w.network_weight)
    assert rec.node_key(3, "x") == jax_rec.node_key(3, "x")


def test_rendered_ledger_with_observations_equals_jax(runs):
    """``render_ledger`` with the reconciliation's observed and residual
    columns, and ``diff_runs`` with both runs' reconciliations."""
    run = ledger.read_ledger(runs["port_apply"])
    jrun = jax_ledger.read_ledger(runs["port_apply"])
    assert ledger.render_ledger(run, rec.reconcile_decisions(run)) == \
        jax_ledger.render_ledger(jrun, jax_rec.reconcile_decisions(jrun))
    other = ledger.read_ledger(runs["port_fit"])
    jother = jax_ledger.read_ledger(runs["port_fit"])
    assert ledger.diff_runs(run, other, rec.reconcile_decisions(run),
                            rec.reconcile_decisions(other)) == \
        jax_ledger.diff_runs(jrun, jother,
                             jax_rec.reconcile_decisions(jrun),
                             jax_rec.reconcile_decisions(jother))


def test_the_kernel_plan_joins_its_chain_kernel_spans(runs):
    """JAX's kernel plan records a ``chain_kernel`` span where the
    unified planner's tagged featurizer runs (the fit's dispatch, its
    kernel in interpret mode), carrying the planner's seconds; the
    kernel decision observes it. The port tags the same chain, but on
    the CPU its plain version runs and K4 never launches, so its trace
    holds no ``chain_kernel`` span and its kernel decision observes no
    dispatch (on the card the span is held by
    `tests/test_torch_cuda_kernels.py::test_cuda_chain_kernel_span_covers_the_kernel`)."""
    label = "Fused[PixelScaler >> GrayScaler >> ImageVectorizer]"
    jrun = ledger.read_ledger(runs["jax_kernel"])
    kernels = rec.reconcile_roofline(jrun["trace"])["kernels"]
    assert kernels
    for row in kernels:
        assert row["family"] == "elementwise_chain"
        assert row["label"] == label
        assert row["predicted_seconds"] > 0
        assert row["observed_seconds"] > 0
        assert row["residual"] is not None
    rows = [r for r in rec.reconcile_decisions(jrun)["rows"]
            if r["kind"] == "kernel"]
    assert rows and rows[0]["observed"]["kernel_dispatches"] >= 1
    assert "kernel_seconds" in rows[0]["residuals"]

    run = ledger.read_ledger(runs["port_kernel"])
    assert not [e for e in run["trace"]["traceEvents"]
                if e.get("name") == "chain_kernel"]
    assert rec.reconcile_roofline(run["trace"])["kernels"] == []
    rows = [r for r in rec.reconcile_decisions(run)["rows"]
            if r["kind"] == "kernel"]
    assert rows and "kernel_dispatches" not in rows[0]["observed"]
    assert [r["labels"] for r in rows] == [
        r["labels"] for r in rec.reconcile_decisions(jrun)["rows"]
        if r["kind"] == "kernel"]


# ---------------------------------------------- the port's own run, pinned


def test_predicted_vs_observed_exactness_mnist(runs):
    run = ledger.read_ledger(runs["port_apply"])
    assert run["trace"] is not None
    assert "megafusion" in {d["kind"] for d in run["decisions"]}
    for d in run["decisions"]:
        assert d["enforced"] and d["chosen"]
        assert len(d["alternatives"]) >= 1
        assert d["predicted"]
    r = rec.reconcile_decisions(run)
    assert r["run_predicted"]["programs_executed"] == 1
    assert r["run_observed"]["programs_executed"] == 1
    assert r["residuals"]["programs_executed"] == 0
    assert r["run_predicted"]["megafused_programs"] == 1
    assert r["run_observed"]["megafused_programs"] == 1
    observed_cold = r["run_observed"].get("programs_compiled")
    if observed_cold is not None:
        assert observed_cold <= r["run_predicted"]["programs_compiled_max"]
    mega = [row for row in r["rows"] if row["kind"] == "megafusion"]
    assert mega[0]["observed"]["programs_executed"] == 1
    assert mega[0]["residuals"]["programs_per_apply"] == 0


def test_warm_reapply_observes_zero_cold_compiles(tmp_path):
    path = str(tmp_path / "warm.json")
    _port_run(path, warm=True)
    r = rec.reconcile_decisions(ledger.read_ledger(path))
    assert r["run_observed"]["programs_executed"] == 1
    assert r["run_predicted"]["programs_executed"] == 1
    assert r["run_observed"].get("programs_compiled", 0) == 0


def test_acceptance_diff_default_vs_megafusion_off(tmp_path):
    path_a, path_b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    pred_a = _port_run(path_a, plan="megafused")
    pred_b = _port_run(path_b, plan="optimized")
    np.testing.assert_array_equal(pred_a, pred_b)
    run_a, run_b = ledger.read_ledger(path_a), ledger.read_ledger(path_b)
    diff = ledger.diff_runs(run_a, run_b, rec.reconcile_decisions(run_a),
                            rec.reconcile_decisions(run_b))
    assert any(f["env"] == "KEYSTONE_MEGAFUSION"
               for f in diff["config_flips"])
    removed = [d for d in diff["decisions_removed"]
               if d["kind"] == "megafusion"]
    assert removed and removed[0]["suspect_env"] == "KEYSTONE_MEGAFUSION"
    regress = {r["metric"]: r for r in diff["observed_regressions"]}
    assert regress["programs_executed"]["a"] == 1
    assert regress["programs_executed"]["b"] > 1
    assert diff["regressions"] >= 3
    # the CLI's --diff reconciles both runs and exits 1 on the regression
    assert telemetry_main(["--diff", path_a, path_b]) == 1


def test_cost_model_drift_from_trace(runs):
    trace = ledger.read_ledger(runs["port_apply"])["trace"]
    drift = rec.cost_model_drift(trace)
    assert drift["spans"] > 0 and drift["observed_bytes"] > 0
    by = {r["weight"]: r for r in drift["rows"]}
    assert by["mem_weight"]["implied"] == pytest.approx(
        drift["observed_seconds"] / drift["observed_bytes"])
    assert by["cpu_weight"]["implied"] > 0 and drift["observed_flops"] > 0
    assert by["network_weight"]["implied"] is None
    assert drift["suggested"]["network_weight"] == \
        by["network_weight"]["current"]
    assert drift["roofline"]["stages_joined"] > 0
    weights = rec.drift_cost_weights(trace)
    assert weights.mem_weight == drift["suggested"]["mem_weight"]
    assert weights.cpu_weight == drift["suggested"]["cpu_weight"]
    text = rec.format_drift(drift)
    assert "unmeasured" in text and "flops residual" in text


def test_emitted_calibration_round_trips(runs, tmp_path, monkeypatch,
                                         capsys):
    """``--ledger <run> --emit-calibration <path>`` writes the implied
    weights in `cuda_calibration.json`'s schema, stamped with the run's
    platform; ``KEYSTONE_COST_CALIBRATION=<path>`` then resolves them."""
    out = str(tmp_path / "cal.json")
    assert telemetry_main(["--ledger", runs["port_apply"],
                           "--emit-calibration", out]) == 0
    assert "wrote" in capsys.readouterr().out
    payload = json.load(open(out))
    want = rec.drift_cost_weights(ledger.read_ledger(
        runs["port_apply"])["trace"])
    assert payload["cpu_weight"] == want.cpu_weight
    assert payload["mem_weight"] == want.mem_weight
    assert payload["provenance"]["platform"] == "cpu"
    assert payload["provenance"]["source"] == "drift_cost_weights"
    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", out)
    assert cost_model.resolve_weights() == (
        want.cpu_weight, want.mem_weight, want.network_weight)
    # --emit-calibration needs --ledger, and a run whose trace is known
    with pytest.raises(SystemExit):
        telemetry_main(["--emit-calibration", out])
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps({"ledger_version": 1}) + "\n")
    assert telemetry_main(["--ledger", str(bare), "--emit-calibration",
                           out]) == 2


def test_emitted_calibration_needs_synchronized_spans_on_a_card(
        runs, tmp_path, capsys):
    """A card's run whose node spans were not synchronized timed the
    host's enqueue, not the card: ``--emit-calibration`` refuses it and
    writes nothing. A trace made with ``trace_run(...,
    synchronize=True)`` is marked so, and its weights are written,
    stamped with the card and with the mark."""
    trace = json.load(open(runs["port_apply"]))
    card = "NVIDIA H100 80GB HBM3"
    ks = trace["keystone"]
    ks["ledger_run"] = dict(ks["ledger_run"], platform=card)
    ks["ledger_headers"] = [dict(h, platform=card)
                            for h in ks["ledger_headers"]]
    assert "node_spans_synchronized" not in ks
    host_timed = tmp_path / "host_timed.json"
    host_timed.write_text(json.dumps(trace))
    out = tmp_path / "cal.json"
    assert telemetry_main(["--ledger", str(host_timed),
                           "--emit-calibration", str(out)]) == 2
    assert "synchronize=True" in capsys.readouterr().err
    assert not out.exists()
    ks["node_spans_synchronized"] = True
    synced = tmp_path / "synced.json"
    synced.write_text(json.dumps(trace))
    assert telemetry_main(["--ledger", str(synced),
                           "--emit-calibration", str(out)]) == 0
    prov = json.load(open(out))["provenance"]
    assert prov["platform"] == card
    assert prov["node_spans_synchronized"] is True


def test_a_synchronizing_tracer_waits_for_each_node(monkeypatch):
    """``trace_run(synchronize=True)`` marks its trace and waits for each
    forced node's value; a plain tracer does neither."""
    from keystone_tpu_torch.telemetry import instrument

    waited = []
    real = instrument.sync_value
    monkeypatch.setattr(instrument, "sync_value",
                        lambda v: (waited.append(v), real(v)))
    predictor, train, test = bench.EXAMPLES["MnistRandomFFT"](CPU)
    predictor(train).get()
    for synchronize in (False, True):
        del waited[:]
        with trace_run(synchronize=synchronize) as tracer:
            predictor(test).get()
            trace = to_chrome_trace(tracer)
        nodes = [e for e in trace["traceEvents"]
                 if e.get("cat") == "node" and "seconds" in e["args"]]
        assert nodes
        assert trace["keystone"].get("node_spans_synchronized", False) \
            is synchronize
        assert len(waited) == (len(nodes) if synchronize else 0)


def test_ledger_cli_renders_observed_columns_and_drift(runs, tmp_path,
                                                       capsys):
    assert telemetry_main(["--ledger", runs["port_apply"]]) == 0
    text = capsys.readouterr().out
    assert "observed" in text and "residual" in text
    assert "== decisions: predicted vs observed" in text
    assert "cost-model drift" in text and "flops residual" in text
    assert telemetry_main(["--ledger", runs["port_apply"], "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["reconciliation"]["run_observed"][
        "programs_executed"] == 1
    assert payload["cost_model_drift"]["spans"] > 0
    # a run with no spans still renders
    bare = load_trace(runs["port_apply"])
    bare["traceEvents"] = []
    art = tmp_path / "no_spans.json"
    art.write_text(json.dumps(bare))
    assert telemetry_main(["--ledger", str(art)]) == 0


def test_cli_summary_includes_memory_reconciliation(runs, capsys):
    text = summarize(load_trace(runs["port_fit"]))
    assert "static vs observed memory" in text
    assert "DelegatingOperator" in text or "BlockLeastSquares" in text
    assert "== roofline (predicted vs observed seconds) ==" in text
    assert telemetry_main([runs["port_fit"], "--json"]) == 0
    digest = json.loads(capsys.readouterr().out)
    assert digest["memory_reconciliation"]["rows"]


def test_reconciliation_static_matches_observed_for_solver_output(runs):
    r = rec.reconcile_trace(load_trace(runs["port_fit"]))
    both = [row for row in r["rows"] if row["rel_error"] is not None]
    assert both
    assert [row for row in both if abs(row["rel_error"]) < 1e-6]
    assert r["observed_peak_bytes"] and r["observed_peak_bytes"] > 0


def test_uint8_pipeline_static_vs_observed_bytes_exact(tmp_path):
    from keystone_tpu_torch.nodes.images.core import (
        ImageVectorizer,
        PixelScaler,
    )

    n, h, w, c = 64, 8, 8, 3
    imgs = np.random.default_rng(0).integers(
        0, 256, size=(n, h, w, c), dtype=np.uint8)
    path = tmp_path / "uint8.json"
    with trace_run(str(path)):
        pipe = PixelScaler().to_pipeline() >> ImageVectorizer()
        pipe(Dataset(imgs, device=CPU)).get()
    r = rec.reconcile_trace(load_trace(str(path)))
    rows = {row["label"]: row for row in r["rows"]}
    src = next(row for label, row in rows.items() if "Dataset" in label)
    assert src["static_bytes"] == n * h * w * c
    assert src["dtype"] == "uint8"
    fused = next(row for label, row in rows.items()
                 if "PixelScaler" in label)
    assert fused["dtype"] == "float32"
    assert fused["rel_error"] == 0.0
    assert "dtype" in rec.format_reconciliation(r)


def test_conformance_record_joins_in_reconcile(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    cert = {"certified": True, "slo_seconds": 0.5,
            "shapes": [{"batch": 64, "predicted_seconds": 0.2}]}
    flight.ensure_flight()
    watchdog.arm_watchdog(cert, pipeline="demo")
    with trace_run() as tracer:
        t0 = tracer.now()
        tracer.record_complete("apply_request", "request", t0, 9.0,
                               batch=64, chunk_shape=64, pipeline="demo")
        watchdog.active_watchdog().check(64, 9.0, batch=64)
        trace = to_chrome_trace(tracer)
    run = {"trace": trace, "decisions": trace["keystone"]["decisions"],
           "header": {}}
    rows = [r for r in rec.reconcile_decisions(run)["rows"]
            if r["kind"] == "conformance"]
    assert len(rows) == 1
    assert rows[0]["observed"]["observed_seconds"] == pytest.approx(9.0)
    assert rows[0]["residuals"]["bound_seconds"] == pytest.approx(0.2 - 9.0)
    assert jax_rec.reconcile_decisions(run) == rec.reconcile_decisions(run)


def _serving_trace(cert_shapes, observed):
    return {"keystone": {
        "serving": {"shapes": cert_shapes, "slo_seconds": 1.0,
                    "certified": True, "dominating_stage": "Stage"},
        "serving_observed": observed,
    }}


def test_reconcile_serving_joins_on_the_padded_shape():
    trace = _serving_trace(
        [{"batch": 1, "predicted_seconds": 0.010, "machine_seconds": 1e-4},
         {"batch": 4, "predicted_seconds": 0.020, "machine_seconds": 2e-4}],
        [{"batch": 1, "chunk_shape": 1, "p50_ms": 6.0, "p99_ms": 9.0},
         {"batch": 3, "chunk_shape": 4, "p50_ms": 8.0},
         {"batch": 9, "chunk_shape": 16, "p50_ms": 9.0}])
    r = rec.reconcile_serving(trace)
    assert r == jax_rec.reconcile_serving(trace)
    assert r["shapes_joined"] == 2 and r["bound_holds"] is True
    by = {row["batch"]: row for row in r["rows"]}
    assert by[3]["predicted_bound_seconds"] == 0.020
    assert by[3]["residual_seconds"] == pytest.approx(0.012)
    assert by[9]["holds"] is None
    text = rec.format_serving_reconciliation(r)
    assert "holds" in text and "unjoined" in text
    assert text == jax_rec.format_serving_reconciliation(r)


def test_reconcile_serving_flags_violations_and_degrades():
    trace = _serving_trace(
        [{"batch": 2, "predicted_seconds": 0.004, "machine_seconds": 1e-4}],
        [{"batch": 2, "chunk_shape": 2, "p50_ms": 11.0}])
    r = rec.reconcile_serving(trace)
    assert r["bound_holds"] is False and r["violations"] == 1
    assert r["rows"][0]["residual_seconds"] < 0
    assert "VIOLATED" in rec.format_serving_reconciliation(r)
    empty = rec.reconcile_serving({"keystone": {}})
    assert empty["rows"] == [] and empty["bound_holds"] is None
    assert "no joined shapes" in rec.format_serving_reconciliation(empty)


def test_reconcile_roofline_tolerates_missing_sides():
    empty = rec.reconcile_roofline({"traceEvents": []})
    assert empty["stages_joined"] == 0 and empty["rows"] == []
    assert empty["flops_residual_seconds"] is None
    one_sided = {"traceEvents": [], "keystone": {"roofline": {"per_node": {
        "3:Stage": {"label": "Stage", "vertex": 3, "flops": 10.0,
                    "bound": "compute", "predicted_seconds": 1e-6}}}}}
    r = rec.reconcile_roofline(one_sided)
    assert r["rows"][0]["residual"] is None
    assert r == jax_rec.reconcile_roofline(one_sided)
    text = rec.format_drift(rec.cost_model_drift({"traceEvents": []}))
    assert "cost-model drift" in text and "flops residual" not in text


def test_trace_embeds_roofline_and_reconciles(runs):
    trace = load_trace(runs["port_fit"])
    roof = trace["keystone"]["roofline"]
    assert roof["per_node"] and roof["peak_flops"] > 0
    assert roof["plan_predicted_seconds"] > 0
    rr = rec.reconcile_roofline(trace)
    assert rr["stages_joined"] > 0
    for row in rr["rows"]:
        if row["residual"] is not None:
            assert row["observed_seconds"] > 0
    assert rr["flops_residual_seconds"] == pytest.approx(
        rr["predicted_seconds"] - rr["observed_seconds"])


def test_chain_predicted_seconds_on_bound_graph():
    from keystone_tpu_torch.nodes.stats import NormalizeRows

    applied = NormalizeRows().to_pipeline().apply(
        Dataset(np.ones((32, 8), np.float32), device=CPU))
    nodes = sorted(applied.graph.operators, key=lambda n: n.id)
    seconds = chain_predicted_seconds(applied.graph, nodes)
    assert seconds is not None and seconds > 0
    assert chain_predicted_seconds(applied.graph, []) is None


def test_fusion_decisions_record_predicted_seconds(tmp_path):
    """Under a tracer each fusion and megafusion record carries the
    chain's roofline seconds; an untraced optimize prices nothing."""
    mark = ledger.session_mark()
    _port_run(str(tmp_path / "fit.json"), fit_in_trace=True)
    traced = [d for d in ledger.session_since(mark)
              if d["kind"] in ("fusion", "megafusion")]
    assert traced and all(d["predicted"]["predicted_seconds"] > 0
                          for d in traced)
    mark = ledger.session_mark()
    bench.measure_example("MnistRandomFFT", "megafused", device="cpu")
    untraced = [d for d in ledger.session_since(mark)
                if d["kind"] in ("fusion", "megafusion")]
    assert untraced and not any("predicted_seconds" in d["predicted"]
                                for d in untraced)


def test_the_chain_kernel_span_needs_a_tracer():
    """The ``chain_kernel`` span exists only under a tracer and only on
    the card, where the planned kernel launches: on the CPU a traced run
    records none, and the span's arguments are those of the chain's
    planned kernel (the card's span is held by
    `tests/test_torch_cuda_kernels.py::test_cuda_chain_kernel_span_covers_the_kernel`)."""
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    chain = FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                   ImageVectorizer()], microbatch=16)
    assert chain.planned_kernel is not None
    x = torch.rand((40, 4, 4, 3)) * 255.0
    assert chain._kernel_span(x) is None
    with trace_run() as tracer:
        assert chain._kernel_span(x) is None
        chain.batch_fn()(x)
        chain.run_rung(x, 48, 12)
        trace = to_chrome_trace(tracer)
    assert not [e for e in trace["traceEvents"]
                if e.get("name") == "chain_kernel"]
    args = chain._kernel_span_args(40)
    assert (args["family"], args["stages"], args["rows"]) == \
        ("elementwise_chain", 3, 40)
    assert args["label"] == chain.label
    assert args["statically_verified"] is None
