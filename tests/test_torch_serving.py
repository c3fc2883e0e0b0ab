"""The port's serving certifier (`keystone_tpu_torch/analysis/serving.py`,
KP901–KP906) against the JAX package's: the cases of
`tests/test_serving.py`, and the certificate of the same tiny fitted
predictor (`RandomSignNode >> PaddedFFT >> LinearRectifier`, gathered,
then BCD and `MaxClassifier`) in both packages.

"Cold" work on the card is a kernel build (a cold
`telemetry/compile_events.py` record), a K4 `ChainPlan` build
(``kernels.chain_plan_builds``) or a CUDA graph capture
(``megafusion.graph_captures``); the CPU tests read the same counters,
and the card's side is `chip_smoke.py`'s serving phase. The reconcile
join of certified bounds with observed latencies
(`tests/test_serving.py:424, 448`) is in `tests/test_torch_reconcile.py`.
"""

import numpy as np
import pytest
import torch

import jax
from keystone_tpu.analysis import ServingEnvelope as JaxEnvelope
from keystone_tpu.analysis import as_source_spec as jax_source_spec
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.analysis.roofline import Machine as JaxMachine
from keystone_tpu.analysis.roofline import roofline_pass as jax_roofline
from keystone_tpu.analysis.serving import serving_pass as jax_serving_pass
from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBlockLS,
)
from keystone_tpu.nodes.stats import LinearRectifier as JaxRectifier
from keystone_tpu.nodes.stats import PaddedFFT as JaxFFT
from keystone_tpu.nodes.stats import RandomSignNode as JaxSign
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
    MaxClassifier as JaxMax,
    VectorCombiner as JaxCombiner,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.workflow import Pipeline as JaxPipeline
from keystone_tpu.workflow import PipelineEnv as JaxEnv
from keystone_tpu.workflow.env import config_override as jax_config
from keystone_tpu_torch.analysis import (
    Machine,
    ServingCertificate,
    ServingEnvelope,
    Severity,
    as_source_spec,
    envelope_from_env,
    ladder_shapes,
    roofline_pass,
    serving_pass,
    warmup_manifest,
)
from keystone_tpu_torch.analysis.examples import build_example
from keystone_tpu_torch.analysis.propagate import spec_pass
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.block_ls import (
    BlockLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats.random_features import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from keystone_tpu_torch.nodes.util.basic import (
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.telemetry import counter
from keystone_tpu_torch.workflow import Pipeline, PipelineEnv
from keystone_tpu_torch.workflow.env import config_override

DIM, N, K = 16, 48, 3
LADDER = (1, 2, 4, 8, 16)
MACHINE = (5e10, 2e10)


@pytest.fixture(autouse=True)
def _reset_env(monkeypatch):
    for var in ("KEYSTONE_SLO_MS", "KEYSTONE_SERVING_MAX_BATCH",
                "KEYSTONE_SERVING_TENANTS"):
        monkeypatch.delenv(var, raising=False)
    PipelineEnv.reset()
    JaxEnv.reset()
    yield
    PipelineEnv.reset()
    JaxEnv.reset()


@pytest.fixture
def one_device_mesh():
    with use_mesh(make_mesh(jax.devices()[:1])) as mesh:
        yield mesh


def _mnist_like():
    pipeline, source_spec = build_example("MnistRandomFFT", device="cpu")
    specs, _ = spec_pass(pipeline.graph,
                         {pipeline.source: as_source_spec(source_spec)})
    return pipeline, specs


def _rules(diags):
    return [d.rule for d in diags]


def _data(label_seed: int = 0):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, DIM)).astype(np.float32)
    y = np.random.default_rng(label_seed).integers(0, K, N).astype(np.int32)
    return X, y


def fit_small_predictor(label_seed: int = 0):
    """gather(2 FFT branches) → BCD → argmax, fit on the CPU: the JAX
    tests' tiny predictor. Returns ``(fitted, X)``."""
    X, y = _data(label_seed)
    branches = [RandomSignNode(DIM, seed=i, device="cpu") >> PaddedFFT()
                >> LinearRectifier(0.0) for i in range(2)]
    feat = Pipeline.gather(branches) >> VectorCombiner()
    labels = ClassLabelIndicatorsFromInt(K)(Dataset(y, device="cpu")).get()
    pred = feat.and_then(BlockLeastSquaresEstimator(32, 1, 1e-2),
                         Dataset(X, device="cpu"), labels) >> MaxClassifier()
    return pred.fit(), X


def jax_fit_small_predictor():
    X, y = _data()
    branches = [JaxSign(DIM, seed=i) >> JaxFFT() >> JaxRectifier(0.0)
                for i in range(2)]
    feat = JaxPipeline.gather(branches) >> JaxCombiner()
    labels = JaxIndicators(K)(JaxDataset.from_numpy(y)).get()
    pred = feat.and_then(JaxBlockLS(32, 1, 1e-2), JaxDataset.from_numpy(X),
                         labels) >> JaxMax()
    return pred.fit(), X


def _direct(fitted, X):
    return fitted.apply(Dataset(X, device="cpu")).array.numpy()


# ------------------------------------------------------------- envelope


def test_envelope_validates_its_contract():
    with pytest.raises(ValueError):
        ServingEnvelope(min_batch=0)
    with pytest.raises(ValueError):
        ServingEnvelope(min_batch=8, max_batch=4)
    with pytest.raises(ValueError):
        ServingEnvelope(slo_seconds=0.0)
    with pytest.raises(ValueError):
        ServingEnvelope(tenants=0)


def test_envelope_from_env_arms_and_disarms(monkeypatch):
    assert envelope_from_env() is None
    monkeypatch.setenv("KEYSTONE_SLO_MS", "250")
    monkeypatch.setenv("KEYSTONE_SERVING_MAX_BATCH", "16")
    monkeypatch.setenv("KEYSTONE_SERVING_TENANTS", "3")
    assert envelope_from_env() == ServingEnvelope(
        max_batch=16, slo_seconds=0.25, tenants=3)
    monkeypatch.setenv("KEYSTONE_SLO_MS", "not-a-number")
    assert envelope_from_env() is None


def test_ladder_shapes_are_the_pad_target_image():
    from keystone_tpu_torch.utils.batching import _pad_target

    shapes = ladder_shapes(ServingEnvelope(max_batch=64), chunk_rows=64)
    assert shapes == [1, 2, 4, 8, 16, 32, 64]
    for b in range(1, 65):
        assert _pad_target(b, 64, b) in shapes
    assert ladder_shapes(ServingEnvelope(max_batch=512),
                         chunk_rows=64)[-1] == 64
    assert ladder_shapes(ServingEnvelope(min_batch=5, max_batch=8),
                         chunk_rows=64) == [8]


# ---------------------------------------------------------- the verdict


def test_certified_pipeline_and_report_surface():
    pipeline, specs = _mnist_like()
    cert, diags = serving_pass(
        pipeline.graph, specs, ServingEnvelope(max_batch=16),
        source=pipeline.source, sink=pipeline.sink, record=False)
    assert isinstance(cert, ServingCertificate)
    assert cert.certified
    assert cert.priced_stages > 0 and cert.unpriced_stages == 0
    assert cert.dominating_stage
    assert [s["batch"] for s in cert.shapes] == list(LADDER)
    for s in cert.shapes:
        assert s["predicted_seconds"] > s["machine_seconds"] > 0
    assert "KP903" in _rules(diags)
    rec = cert.as_record()
    assert rec["certified"] and rec["shapes"] and rec["warmup_manifest"]


def test_validate_attaches_certificate_only_when_armed(monkeypatch):
    pipeline, source_spec = build_example("MnistRandomFFT", device="cpu")
    report = pipeline.validate(source_spec, raise_on_error=False)
    assert report.serving is None
    report = pipeline.validate(
        source_spec, serving=ServingEnvelope(max_batch=8),
        raise_on_error=False)
    assert report.serving is not None and report.serving.certified
    monkeypatch.setenv("KEYSTONE_SLO_MS", "500")
    report = pipeline.validate(source_spec, raise_on_error=False)
    assert report.serving is not None
    assert report.serving.envelope.slo_seconds == 0.5


def test_kp901_names_host_stages_and_their_fix():
    pipeline, source_spec = build_example("NewsgroupsPipeline", device="cpu")
    specs, _ = spec_pass(pipeline.graph,
                         {pipeline.source: as_source_spec(source_spec)})
    cert, diags = serving_pass(pipeline.graph, specs, record=False)
    errors = [d for d in diags if d.rule == "KP901"]
    assert errors and not cert.certified
    assert "Trim" in {d.label for d in errors}
    assert all("Fix:" in d.message for d in errors)


def test_kp903_busted_slo_names_the_dominating_stage():
    pipeline, specs = _mnist_like()
    cert, diags = serving_pass(
        pipeline.graph, specs,
        ServingEnvelope(max_batch=64, slo_seconds=1e-9),
        source=pipeline.source, sink=pipeline.sink, record=False)
    assert not cert.certified
    bust = [d for d in diags
            if d.rule == "KP903" and d.severity == Severity.ERROR]
    assert len(bust) == 1
    assert cert.dominating_stage in bust[0].message
    assert f"batch {cert.worst_shape['batch']}" in bust[0].message


def test_kp904_flags_an_in_place_write_into_the_request():
    class _InPlaceRectifier(LinearRectifier):
        donates_deps = (0,)

    pipe = RandomSignNode(8, device="cpu").to_pipeline() \
        >> _InPlaceRectifier(0.0)
    specs, _ = spec_pass(pipe.graph, {pipe.source: as_source_spec((8,))})
    _, diags = serving_pass(pipe.graph, specs, record=False)
    assert "KP904" not in _rules(diags)

    pipe2 = _InPlaceRectifier(0.0).to_pipeline() \
        >> RandomSignNode(8, device="cpu")
    specs2, _ = spec_pass(pipe2.graph, {pipe2.source: as_source_spec((8,))})
    cert, diags2 = serving_pass(pipe2.graph, specs2, record=False)
    kp904 = [d for d in diags2 if d.rule == "KP904"]
    assert len(kp904) == 1 and kp904[0].severity == Severity.ERROR
    assert not cert.certified


def test_kp905_prices_multi_tenant_residency():
    pipeline, specs = _mnist_like()
    _, diags = serving_pass(
        pipeline.graph, specs, ServingEnvelope(tenants=2),
        source=pipeline.source, sink=pipeline.sink,
        hbm_budget_bytes=1 << 40, record=False)
    info = [d for d in diags if d.rule == "KP905"]
    assert len(info) == 1 and info[0].severity == Severity.INFO
    cert, diags = serving_pass(
        pipeline.graph, specs, ServingEnvelope(tenants=1_000_000),
        source=pipeline.source, sink=pipeline.sink,
        hbm_budget_bytes=1 << 20, record=False)
    over = [d for d in diags if d.rule == "KP905"]
    assert len(over) == 1 and over[0].severity == Severity.ERROR
    assert not cert.certified


def test_kp906_flags_dynamic_metric_names_on_instantiated_operators():
    class _ChattyRectifier(LinearRectifier):
        def apply(self, x):
            from keystone_tpu_torch.telemetry import counter

            counter(f"serve.{self.label}").inc()
            return super().apply(x)

    pipe = RandomSignNode(8, device="cpu").to_pipeline() \
        >> _ChattyRectifier(0.0)
    specs, _ = spec_pass(pipe.graph, {pipe.source: as_source_spec((8,))})
    _, diags = serving_pass(pipe.graph, specs, record=False)
    kp906 = [d for d in diags if d.rule == "KP906"]
    assert len(kp906) == 1 and kp906[0].severity == Severity.WARNING
    assert "apply" in kp906[0].message

    class _HistogramRectifier(LinearRectifier):
        def apply(self, x):
            return torch.histogram(x, bins=int(x.shape[-1]))[0]

    # torch.histogram is math, not a metric factory
    pipe2 = RandomSignNode(8, device="cpu").to_pipeline() \
        >> _HistogramRectifier(0.0)
    specs2, _ = spec_pass(pipe2.graph, {pipe2.source: as_source_spec((8,))})
    _, diags2 = serving_pass(pipe2.graph, specs2, record=False)
    assert [d for d in diags2 if d.rule == "KP906"] == []


def test_serving_cert_lands_in_the_ledger():
    from keystone_tpu_torch.telemetry import ledger

    pipeline, specs = _mnist_like()
    mark = ledger.session_mark()
    serving_pass(pipeline.graph, specs, ServingEnvelope(max_batch=8),
                 source=pipeline.source, sink=pipeline.sink,
                 label="MnistRandomFFT")
    records = [d for d in ledger.session_since(mark)
               if d["kind"] == "serving_cert"]
    assert len(records) == 1
    rec = records[0]
    assert rec["labels"] == ["MnistRandomFFT"]
    assert rec["chosen"]["entry"] == "certified"
    assert [a["entry"] for a in rec["alternatives"]] == [
        "batch=1", "batch=2", "batch=4", "batch=8"]
    assert rec["predicted"]["worst_shape_seconds"] > 0


# ------------------------------------------------------ warmup manifest


def test_warmup_manifest_enumerates_sites_times_ladder():
    pipeline, source_spec = build_example("MnistRandomFFT", device="cpu")
    manifest = warmup_manifest(
        pipeline.graph, {pipeline.source: as_source_spec(source_spec)},
        envelope=ServingEnvelope(max_batch=16))
    assert manifest
    for entry in manifest:
        assert entry["counts"] == list(LADDER)
        assert hasattr(entry["element"], "shape")
        assert "Fused[" in entry["label"]


def _cold_work():
    from keystone_tpu_torch.telemetry import compiles_snapshot

    return (compiles_snapshot()["programs_compiled"],
            counter("megafusion.graph_captures").value,
            counter("kernels.chain_plan_builds").value)


def test_armed_envelope_warm_serves_every_ladder_shape_with_no_cold_work(
        monkeypatch):
    """With an envelope armed, the executor's warm-up covers the ladder:
    serving every rung afterwards records no kernel build, no capture and
    no launch-plan build, and matches the batch apply row for row."""
    from keystone_tpu_torch.workflow.executor import drain_warmups

    monkeypatch.setenv("KEYSTONE_SLO_MS", "1000")
    monkeypatch.setenv("KEYSTONE_SERVING_MAX_BATCH", str(max(LADDER)))
    fitted, X = fit_small_predictor()
    batch_ref = _direct(fitted, X)
    with config_override(aot_warmup=True):
        _direct(fitted, X[:1])
        drain_warmups()
        cold = _cold_work()
        preds = [_direct(fitted, X[:b]) for b in LADDER]
    assert _cold_work() == cold
    for b, p in zip(LADDER, preds):
        assert (p == batch_ref[:b]).all()


def test_warm_manifest_drives_ladder_warmup_without_env():
    from keystone_tpu_torch.workflow.executor import warm_fitted_manifest

    fitted, X = fit_small_predictor()
    manifest = warmup_manifest(
        fitted.graph, {fitted.source: as_source_spec((DIM,))},
        envelope=ServingEnvelope(max_batch=max(LADDER)))
    assert manifest and manifest[0]["counts"] == list(LADDER)
    warmed = warm_fitted_manifest(fitted, manifest,
                                  np.zeros((1, DIM), np.float32),
                                  device="cpu")
    assert warmed >= 1
    cold = _cold_work()
    for b in LADDER:
        _direct(fitted, X[:b])
    assert _cold_work() == cold


def test_executor_embeds_certificate_in_trace_metadata(monkeypatch):
    from keystone_tpu_torch.telemetry import active_watchdog, trace_run
    from keystone_tpu_torch.telemetry.export import to_chrome_trace
    from keystone_tpu_torch.telemetry.watchdog import disarm_watchdog

    monkeypatch.setenv("KEYSTONE_SLO_MS", "1000")
    monkeypatch.setenv("KEYSTONE_SERVING_MAX_BATCH", "4")
    fitted, X = fit_small_predictor()
    try:
        with trace_run() as tracer:
            _direct(fitted, X[:2])
        trace = to_chrome_trace(tracer)
        cert = trace["keystone"].get("serving")
        assert cert is not None
        assert cert["slo_seconds"] == 1.0
        assert [s["batch"] for s in cert["shapes"]] == [1, 2, 4]
        assert all(s["predicted_seconds"] > 0 for s in cert["shapes"])
        assert trace["keystone"]["static_memory"]["peak_bytes"] > 0
        assert trace["keystone"]["roofline"]["per_node"]
        wd = active_watchdog()
        assert wd is not None and set(wd.bounds) == {1, 2, 4}
    finally:
        disarm_watchdog()


# ----------------------------------------- the fitted predictor vs JAX


def test_fitted_certificate_matches_jax(one_device_mesh):
    """The tiny predictor fit in both packages: the same verdict, rule
    ids and severities, ladder, manifest (sites × counts) and dominating
    stage under one machine."""
    with jax_config(chunk_size=256), config_override(chunk_size=256):
        jfitted, _ = jax_fit_small_predictor()
        jspecs, _ = jax_spec_pass(jfitted.graph, {
            jfitted.source: jax_source_spec((DIM,))})
        jroof, _ = jax_roofline(jfitted.graph, jspecs,
                                machine=JaxMachine(*MACHINE))
        jc, jd = jax_serving_pass(
            jfitted.graph, jspecs, JaxEnvelope(max_batch=16),
            source=jfitted.source, sink=jfitted.sink, roofline=jroof,
            record=False)
        fitted, _ = fit_small_predictor()
        specs, _ = spec_pass(fitted.graph, {
            fitted.source: as_source_spec((DIM,))})
        roof, _ = roofline_pass(fitted.graph, specs,
                                machine=Machine(*MACHINE))
        tc, td = serving_pass(
            fitted.graph, specs, ServingEnvelope(max_batch=16),
            source=fitted.source, sink=fitted.sink, roofline=roof,
            record=False)
    assert tc.certified and jc.certified
    assert sorted((d.rule, int(d.severity)) for d in td) == \
        sorted((d.rule, int(d.severity)) for d in jd)
    assert [s["batch"] for s in tc.shapes] == [s["batch"] for s in jc.shapes]
    assert [(e["label"], e["counts"]) for e in tc.manifest] == \
        [(e["label"], e["counts"]) for e in jc.manifest]
    assert tc.dominating_stage == jc.dominating_stage
    assert tc.programs == jc.programs
    for a, b in zip(jc.shapes, tc.shapes):
        assert b["predicted_seconds"] == pytest.approx(
            a["predicted_seconds"], rel=0.05)


def test_swap_check_holds_every_answer_to_a_version():
    """`serving/swap_check.py` at a small size on the CPU: two swaps,
    each to a fresh load, under four client threads; every dispatch's
    rows are the old or the new version's scores, and no request is
    lost."""
    from keystone_tpu_torch.serving.swap_check import swap_check

    report = swap_check(swaps=2, gap=0.05, clients=4, n_train=600,
                        n_test=300, filters=16, requests=300, device="cpu")
    assert [w["to"] for w in report["swaps"]] == ["b", "a"]
    assert report["dispatches"] > 0
    assert report["neither_count"] == 0, report["neither"]
    assert report["errors"] == []


def test_capture_race_needs_the_card():
    """The capture race runs CUDA graphs: on the CPU it refuses, and
    without a card its default device raises."""
    from keystone_tpu_torch.serving.capture_race import capture_race

    with pytest.raises(ValueError, match="needs the card"):
        capture_race(0.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            capture_race(0.0)
