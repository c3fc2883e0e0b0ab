"""The port's serving runtime (`keystone_tpu_torch/serving/`): the cases
of `tests/test_serving_runtime.py`, on the CPU with the same tiny fitted
predictor.

A started runtime dispatches only on the certified pad ladder, adds no
cold work after `start()` (no kernel build, graph capture or launch-plan
build), answers as the direct `FittedPipeline.apply` does, sheds
overload with a count and a flight dump, hot-swaps with no request lost,
refuses an over-budget tenant (KP905), and with
``KEYSTONE_SERVING_COALESCE=0`` applies each request on its caller's
thread bit for bit. Requests and answers are host numpy arrays; on the
CPU the runtime is built with ``device="cpu"``.
"""

import sys
import threading
import time

import numpy as np
import pytest

from test_torch_serving import DIM, N, _direct, fit_small_predictor

from keystone_tpu_torch.analysis import ServingEnvelope
from keystone_tpu_torch.serving import (
    AdmissionRefused,
    CertificationError,
    IngressError,
    MicroBatcher,
    NdarrayIngress,
    ServingRuntime,
    ShedError,
    TenantRegistry,
    TextIngress,
    split_fitted_at,
)
from keystone_tpu_torch.telemetry import compiles_snapshot, counter, ledger
from keystone_tpu_torch.telemetry.flight import reset_flight
from keystone_tpu_torch.telemetry.streaming import reset_live
from keystone_tpu_torch.telemetry.watchdog import (
    active_watchdog,
    disarm_watchdog,
)
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.env import config_override

LADDER = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _reset_env(monkeypatch):
    for var in ("KEYSTONE_SLO_MS", "KEYSTONE_SERVING_MAX_BATCH",
                "KEYSTONE_SERVING_TENANTS", "KEYSTONE_SERVING_COALESCE",
                "KEYSTONE_SERVING_QUEUE_DEPTH",
                "KEYSTONE_SERVING_WINDOW_MS"):
        monkeypatch.delenv(var, raising=False)
    PipelineEnv.reset()
    reset_live()
    yield
    disarm_watchdog()
    reset_flight()
    reset_live()
    PipelineEnv.reset()


@pytest.fixture(scope="module")
def fitted_and_data():
    return fit_small_predictor()


def _runtime(fitted, max_batch: int = 8, **kw):
    kw.setdefault("envelope", ServingEnvelope(max_batch=max_batch,
                                              slo_seconds=1.0))
    kw.setdefault("name", "test-runtime")
    kw.setdefault("device", "cpu")
    return ServingRuntime(fitted, NdarrayIngress((DIM,)), **kw)


def _fire(rt, X, indices, timeout=60.0):
    """Submit rows concurrently; returns (results dict, errors list)."""
    results, errors = {}, []

    def client(i):
        try:
            results[i] = rt.submit(X[i], timeout=timeout)
        except Exception as e:  # noqa: BLE001 - recorded for asserts
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in indices]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * timeout)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def _cold_work():
    return (compiles_snapshot()["programs_compiled"],
            counter("megafusion.graph_captures").value,
            counter("kernels.chain_plan_builds").value)


# --------------------------------------------------------- core dispatch


def test_runtime_asks_for_the_card_by_default(fitted_and_data):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    fitted, _ = fitted_and_data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingRuntime(fitted, NdarrayIngress((DIM,)))


def test_concurrent_requests_coalesce_on_ladder_and_match_direct(
        fitted_and_data):
    fitted, X = fitted_and_data
    ref = _direct(fitted, X)
    rt = _runtime(fitted).start()
    try:
        results, errors = _fire(rt, X, range(8))
        assert not errors, errors
        for i in range(8):
            assert np.allclose(results[i], ref[i]), i
        stats = rt.stats()
        assert stats["dispatched_shapes"]
        assert stats["dispatched_outside_ladder"] == []
    finally:
        rt.stop()


def test_single_request_matches_direct_apply(fitted_and_data):
    fitted, X = fitted_and_data
    ref = _direct(fitted, X)
    rt = _runtime(fitted).start()
    try:
        assert np.allclose(rt.submit(X[3]), ref[3])
        assert rt.stats()["dispatched_outside_ladder"] == []
    finally:
        rt.stop()


def test_saturated_queue_path_matches_direct_apply(fitted_and_data):
    fitted, X = fitted_and_data
    ref = _direct(fitted, X)
    rt = _runtime(fitted, max_batch=4).start()
    before = counter("serving.dispatches").value
    try:
        results, errors = _fire(rt, X, range(32))
        assert not errors, errors
        for i in range(32):
            assert np.allclose(results[i], ref[i]), i
        assert rt.stats()["dispatched_outside_ladder"] == []
        assert counter("serving.dispatches").value - before >= 8
    finally:
        rt.stop()


def test_warm_runtime_serves_full_ladder_with_no_cold_work(fitted_and_data):
    fitted, X = fitted_and_data
    rt = _runtime(fitted).start()  # start() warms every rung
    try:
        cold = _cold_work()
        for b in LADDER:
            results, errors = _fire(rt, X, range(b))
            assert not errors and len(results) == b
        assert _cold_work() == cold
        assert rt.stats()["dispatched_outside_ladder"] == []
    finally:
        rt.stop()


def test_ragged_coalesced_batch_pads_onto_ladder(fitted_and_data):
    """A window can close on any count ≤ max_batch: the dispatch pads it
    onto its pow-2 rung and slices the riders back out."""
    fitted, X = fitted_and_data
    ref = _direct(fitted, X)
    rt = _runtime(fitted).start()
    try:
        cold = _cold_work()
        outs = {n: rt._apply_batch(X[:n]) for n in (3, 5, 6, 7)}
        assert _cold_work() == cold
        for n, out in outs.items():
            assert out.shape[0] == n
            assert np.allclose(out, ref[:n]), n
        stats = rt.stats()
        assert stats["dispatched_outside_ladder"] == []
        assert set(stats["dispatched_shapes"]) <= {4, 8}
    finally:
        rt.stop()


def test_concurrent_applies_of_one_fitted_pipeline_keep_their_rows(
        fitted_and_data):
    """Several threads applying one fitted pipeline at one rung at once
    (the kill switch's callers) each get their own rows: on the card a
    rung's captured graph is replayed under its loop's lock
    (`utils/graphs.py::CapturedLoop.__call__`); here the padded loop runs
    eagerly on each caller's own tensors."""
    fitted, X = fitted_and_data
    want = [_direct(fitted, X[i:i + 1])[0] for i in range(N)]
    got, errors = {}, []

    def client(i):
        try:
            for _ in range(3):
                got[i] = _direct(fitted, X[i:i + 1])[0]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(N)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert all(np.array_equal(got[i], want[i]) for i in range(N))


# ------------------------------------------------------------- hot swap


def test_hot_swap_mid_traffic_loses_nothing_and_flips_atomically():
    fitted_a, X = fit_small_predictor(label_seed=0)
    PipelineEnv.reset()
    fitted_b, _ = fit_small_predictor(label_seed=99)
    ref_a = _direct(fitted_a, X)
    ref_b = _direct(fitted_b, X)
    assert not np.array_equal(ref_a, ref_b)
    rt = _runtime(fitted_a).start()
    try:
        stop_traffic = threading.Event()
        outcomes, errors = [], []

        def client_loop(i):
            while not stop_traffic.is_set():
                try:
                    out = rt.submit(X[i % N])
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return
                outcomes.append((np.allclose(out, ref_a[i % N]),
                                 np.allclose(out, ref_b[i % N])))
                i += 4

        threads = [threading.Thread(target=client_loop, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        swaps = counter("serving.hot_swaps").value
        rt.swap(fitted_b)
        time.sleep(0.3)
        stop_traffic.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, f"hot swap dropped requests: {errors[:3]}"
        assert outcomes and all(a or b for a, b in outcomes)
        assert np.allclose(rt.submit(X[5]), ref_b[5])
        assert rt.certificate is not None and rt.certificate.certified
        assert counter("serving.hot_swaps").value == swaps + 1
    finally:
        rt.stop()


# ----------------------------------------------------- admission (KP905)


def test_registry_refuses_over_budget_tenant_statically(fitted_and_data):
    fitted, _ = fitted_and_data
    rt = _runtime(fitted)
    registry = TenantRegistry(hbm_budget_bytes=1000)
    registry.admit("tenant-a", rt, per_device_peak_bytes=600)
    mark = ledger.session_mark()
    with pytest.raises(AdmissionRefused, match="KP905"):
        registry.admit("tenant-b", rt, per_device_peak_bytes=600)
    assert registry.tenants() == ["tenant-a"]
    assert registry.resident_bytes() == 600
    records = [r for r in ledger.session_since(mark)
               if r["kind"] == "serving_admission"]
    assert records and records[-1]["chosen"]["entry"] == "refuse"
    registry.evict("tenant-a")
    registry.admit("tenant-b", rt, per_device_peak_bytes=600)
    assert registry.tenants() == ["tenant-b"]


def test_runtime_certificate_carries_priced_residency(fitted_and_data):
    fitted, _ = fitted_and_data
    rt = _runtime(fitted).start()
    try:
        peak = rt.certificate.per_device_peak_bytes
        assert peak
        registry = TenantRegistry(hbm_budget_bytes=1 << 40)
        registry.admit("priced", rt)
        assert registry.resident_bytes() == peak
        with pytest.raises(AdmissionRefused):
            TenantRegistry(hbm_budget_bytes=peak - 1).admit("over", rt)
    finally:
        rt.stop()


# ----------------------------------------------------------- load shed


def test_shed_increments_counter_and_dumps_flight_ring(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    release = threading.Event()

    def slow_apply(batch):
        release.wait(10.0)
        return batch

    with config_override(serving_queue_depth=1, serving_window_ms=0.0):
        mb = MicroBatcher(slow_apply, max_batch=1).start()
    before = counter("serving.shed_total").value
    try:
        row = np.zeros(4, np.float32)
        threads, shed = [], []

        def client():
            try:
                mb.submit(row, timeout=20.0)
            except ShedError as e:
                shed.append(e)

        for _ in range(8):
            t = threading.Thread(target=client)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 5.0
        while not shed and time.monotonic() < deadline:
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(timeout=30)
        assert shed
        assert counter("serving.shed_total").value - before >= len(shed)
        assert list(tmp_path.glob("keystone_flight_*_shed.json"))
    finally:
        release.set()
        mb.stop()


def test_shed_runtime_answers_the_admitted_requests_right(fitted_and_data,
                                                          tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("KEYSTONE_FLIGHT_DIR", str(tmp_path))
    fitted, X = fitted_and_data
    ref = _direct(fitted, X)
    with config_override(serving_queue_depth=2):
        rt = _runtime(fitted, max_batch=2).start()
    try:
        results, errors = _fire(rt, X, range(N))
        assert all(isinstance(e, ShedError) for _, e in errors)
        for i, out in results.items():
            assert np.allclose(out, ref[i]), i
    finally:
        rt.stop()


# --------------------------------------------------------- kill switch


def test_coalesce_kill_switch_reverts_to_per_request_bit_for_bit(
        fitted_and_data):
    fitted, X = fitted_and_data
    with config_override(serving_coalesce=False):
        rt = _runtime(fitted).start()
        try:
            assert rt._batcher._thread is None
            results, errors = _fire(rt, X, range(16))
            assert not errors
            for i in range(16):
                ref = _direct(fitted, X[i:i + 1])[0]
                assert np.array_equal(np.asarray(results[i]), ref), i
            assert rt.stats()["dispatched_shapes"] == [1]
        finally:
            rt.stop()


# -------------------------------------------------------------- ingress


def test_ingress_refuses_off_schema_requests(fitted_and_data):
    fitted, X = fitted_and_data
    rt = _runtime(fitted).start()
    try:
        with pytest.raises(IngressError, match="declared ingress"):
            rt.submit(np.zeros(DIM + 1, np.float32))
        with pytest.raises(IngressError):
            rt.submit(np.zeros((2, DIM), np.float32))
        assert rt.submit(X[0].astype(np.float64)) is not None
    finally:
        rt.stop()


def test_uncertified_pipeline_is_refused_at_start(fitted_and_data):
    fitted, _ = fitted_and_data
    rt = _runtime(fitted, envelope=ServingEnvelope(
        max_batch=8, slo_seconds=1e-9))
    with pytest.raises(CertificationError, match="KP903"):
        rt.start()
    assert active_watchdog() is None


# ------------------------------------------------- text ingress (split)


def test_text_ingress_serves_newsgroups_device_tail():
    from keystone_tpu_torch.data.dataset import HostDataset
    from keystone_tpu_torch.pipelines.text_pipelines import (
        build_newsgroups_predictor,
        synthetic_corpus,
    )

    labels, docs = synthetic_corpus(64, 3, vocab_size=120, doc_len=30)
    docs = HostDataset(docs.items, device="cpu")
    fitted = build_newsgroups_predictor(
        docs, labels, 3, ngram_orders=(1,), common_features=500).fit()
    doc_list = list(docs)
    direct = [int(fitted.apply(d)) for d in doc_list[:6]]
    host_ops, tail = split_fitted_at(fitted, "NaiveBayesModel")
    # the port's text model caches its pairs and its CSR (`Cacher`s the
    # JAX package's `build_newsgroups_predictor` lacks); both pass items
    # through at ingress
    assert [op.label for op in host_ops] == [
        "Trim", "LowerCase", "Tokenizer", "NGramsFeaturizer",
        "TermFrequency", "Cacher[text-features]", "SparseFeatureVectorizer",
        "Cacher[text-csr]"]
    ingress = TextIngress(host_ops)
    row = ingress.accept(doc_list[0])
    rt = ServingRuntime(
        tail, ingress, element_shape=row.shape,
        envelope=ServingEnvelope(max_batch=8, slo_seconds=1.0),
        name="newsgroups", device="cpu").start()
    try:
        assert rt.certificate.certified
        results, errors = _fire(rt, doc_list, range(6))
        assert not errors, errors
        for i in range(6):
            assert int(np.asarray(results[i])) == direct[i]
        assert rt.stats()["dispatched_outside_ladder"] == []
        with pytest.raises(IngressError, match="document string"):
            rt.submit(123)
    finally:
        rt.stop()


def test_split_refuses_missing_boundary(fitted_and_data):
    fitted, _ = fitted_and_data
    with pytest.raises(ValueError, match="not on the apply path"):
        split_fitted_at(fitted, "NoSuchStage")


# ------------------------------------------------------ handoff record


def test_start_emits_certificate_handoff_record(fitted_and_data):
    fitted, _ = fitted_and_data
    mark = ledger.session_mark()
    rt = _runtime(fitted).start()
    try:
        records = [r for r in ledger.session_since(mark)
                   if r["kind"] == "serving_handoff"]
        assert len(records) == 1
        rec = records[0]
        assert rec["labels"] == ["test-runtime"]
        assert rec["chosen"]["entry"] == "coalesced micro-batching"
        assert rec["chosen"]["ladder_shapes"] == list(LADDER)
        assert rec["chosen"]["warmed_sites"] == rt.warmed_sites >= 1
        assert rec["predicted"]["worst_shape_seconds"] > 0
        wd = active_watchdog()
        assert wd is not None and set(wd.bounds) == set(LADDER)
    finally:
        rt.stop()
    assert active_watchdog() is None
