"""The out-of-core tier on the CPU, side by side with the JAX package.

The port's counterparts of `tests/test_out_of_core.py:52-275`:
`utils/batching.py`'s spill windows, `data/dataset.py`'s
`SpilledDataset` and `OutOfCoreDataset`, `loaders/ooc_loader.py`, and
the unified planner's spill axis with its enforcement as a host-placed
`CacheMarker`. JAX runs on a one-device mesh on the same numpy data;
both packages price with JAX's CPU rates (the port's CPU analytic
rates too). Stated tolerance: outputs disagree with the unbudgeted run,
and with JAX's, on fewer than 1% of rows (argmax ties at the float
noise floor, JAX's own bound).
"""

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.analysis.plan_ir import plan_unified as jax_plan_unified
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.dataset import OutOfCoreDataset as JaxOOC
from keystone_tpu.loaders import synthetic_out_of_core as jax_synthetic
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBLS,
)
from keystone_tpu.nodes.stats import LinearRectifier as JaxRectifier
from keystone_tpu.nodes.stats import PaddedFFT as JaxFFT
from keystone_tpu.nodes.stats import RandomSignNode as JaxSign
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util import MaxClassifier as JaxMax
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.utils.batching import (
    map_spill_windows as jax_map_windows,
)
from keystone_tpu.utils.batching import (
    stream_spill_windows as jax_stream_windows,
)
from keystone_tpu.workflow.env import PipelineEnv as JaxEnv
from keystone_tpu.workflow.env import config_override as jax_config
from keystone_tpu.workflow.env import overlap_override as jax_overlap
from keystone_tpu_torch.analysis.plan_ir import plan_unified
from keystone_tpu_torch.analysis.propagate import spec_pass
from keystone_tpu_torch.data.dataset import (
    Dataset,
    OutOfCoreDataset,
    SpilledDataset,
)
from keystone_tpu_torch.loaders import (
    out_of_core_from_shards,
    out_of_core_npy_loader,
    synthetic_out_of_core,
)
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
)
from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer
from keystone_tpu_torch.telemetry import counter, ledger
from keystone_tpu_torch.utils.batching import (
    _window_plan,
    map_spill_windows,
    stream_spill_windows,
)
from keystone_tpu_torch.workflow.autocache import CacheMarker
from keystone_tpu_torch.workflow.env import (
    PipelineEnv,
    config_override,
    overlap_override,
)

TIGHT = 32 << 10  # busts every device cache at n=4096, dim=64
MAX_DISAGREE = 0.01


@pytest.fixture(autouse=True)
def _one_device():
    with use_mesh(make_mesh(jax.devices()[:1])):
        yield
    PipelineEnv.reset()
    JaxEnv.reset()


def _host_rows(n, dim=16, seed=0):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _loader(X):
    return lambda lo, hi: X[lo:hi]


# ------------------------------------------------- windowed streaming


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial", "overlapped"])
@pytest.mark.parametrize("count", [512, 513, 3 * 128 - 29],
                         ids=["multiple", "ragged+1", "ragged-tail"])
def test_spill_windows_cover_exactly_and_reassemble(count, overlap):
    """Each index once, in order; each window padded on the ladder as
    JAX pads it; the true rows reassemble the source bit for bit."""
    X = _host_rows(count)
    with overlap_override(overlap), jax_overlap(overlap):
        got = [(list(i), w.shape[0], w[: len(i)].numpy()) for i, w in
               stream_spill_windows(_loader(X), count, 128, device="cpu")]
        want = [(list(i), np.asarray(w).shape[0]) for i, w in
                jax_stream_windows(_loader(X), count, window=128)]
    assert [g[:2] for g in got] == want
    assert [i for g in got for i in g[0]] == list(range(count))
    np.testing.assert_array_equal(np.concatenate([g[2] for g in got]), X)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial", "overlapped"])
def test_map_spill_windows_slices_padding_off(overlap):
    count = 5 * 64 - 17
    X = _host_rows(count)
    out = np.zeros_like(X)
    want = np.zeros_like(X)
    with overlap_override(overlap), jax_overlap(overlap):
        for idxs, rows in map_spill_windows(_loader(X), count,
                                            lambda w: w * 2.0, 64,
                                            device="cpu"):
            assert rows.shape[0] == len(idxs)
            out[idxs] = rows.numpy()
        for idxs, results in jax_map_windows(_loader(X), count,
                                             lambda w: w * 2.0, window=64):
            for i, r in zip(idxs, results):
                want[i] = np.asarray(r)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(out, X * 2.0, rtol=1e-6)


def test_window_trips_are_counted():
    count = 4 * 128
    before = counter("spill.window_trips").value
    list(stream_spill_windows(_loader(_host_rows(count)), count, 128,
                              device="cpu"))
    assert counter("spill.window_trips").value - before == 4
    assert _window_plan(300, 128) == [(0, 128, 128), (128, 256, 128),
                                      (256, 300, 128)]
    assert _window_plan(5, 128) == [(0, 5, 8)]


# --------------------------------------------------- the dataset forms


def _sharded(X, bounds, cls, **kw):
    return cls([(lambda lo=lo, hi=hi: X[lo:hi])
                for lo, hi in zip(bounds, bounds[1:])],
               [hi - lo for lo, hi in zip(bounds, bounds[1:])], **kw)


def test_row_loader_crosses_shards():
    X = _host_rows(1000, dim=8)
    bounds = [0, 256, 512, 768, 1000]  # a ragged last shard
    ds = _sharded(X, bounds, OutOfCoreDataset, device="cpu")
    jds = _sharded(X, bounds, JaxOOC)
    assert ds.count == jds.count == 1000 and ds.is_out_of_core
    for lo, hi in ((200, 600), (760, 1000), (0, 1)):
        np.testing.assert_array_equal(ds.row_loader(lo, hi),
                                      jds.row_loader(lo, hi))
    seen = []
    for idxs, win in ds.window_iter(window=128):
        seen.extend(idxs)
        np.testing.assert_array_equal(win[: len(idxs)].numpy(),
                                      X[idxs[0]: idxs[-1] + 1])
    assert seen == list(range(1000))
    np.testing.assert_array_equal(ds.materialize().array.numpy(), X)
    idx = [999, 3, 512, 300]
    np.testing.assert_array_equal(ds.gather(idx), X[idx])
    with pytest.raises(IndexError):
        ds.row_loader(0, 1001)


def test_synthetic_source_is_deterministic_and_jaxs():
    a = synthetic_out_of_core(600, 8, shard_rows=256, device="cpu")
    b = synthetic_out_of_core(600, 8, shard_rows=256, device="cpu")
    j = jax_synthetic(600, 8, shard_rows=256)
    np.testing.assert_array_equal(a.row_loader(100, 500),
                                  b.row_loader(100, 500))
    np.testing.assert_array_equal(a.row_loader(100, 500),
                                  j.row_loader(100, 500))
    assert a.nbytes == j.nbytes == 600 * 8 * 4


def test_npy_loader_reads_headers_only(tmp_path):
    X = _host_rows(70, dim=3)
    for i, (lo, hi) in enumerate(((0, 32), (32, 64), (64, 70))):
        np.save(tmp_path / f"shard{i}.npy", X[lo:hi])
    ds = out_of_core_npy_loader(str(tmp_path / "shard*.npy"), device="cpu")
    assert ds.count == 70 and ds._hot == (None, None)  # nothing loaded
    np.testing.assert_array_equal(ds.row_loader(30, 66), X[30:66])
    with pytest.raises(FileNotFoundError):
        out_of_core_npy_loader(str(tmp_path / "none*.npy"), device="cpu")
    src = out_of_core_from_shards([lambda: X[:5]], [5], device="cpu")
    np.testing.assert_array_equal(src.take(3), X[:3])


def test_spilled_dataset_round_trip_counts_bytes():
    X = _host_rows(300, dim=8)
    ds = Dataset(X, device="cpu")
    out0 = counter("spill.bytes_out").value
    spilled = SpilledDataset.spill(ds)
    assert spilled.is_spilled and spilled.count == 300
    assert counter("spill.bytes_out").value - out0 >= X.nbytes
    in0 = counter("spill.bytes_in").value
    back = spilled.rehydrate()
    assert counter("spill.bytes_in").value - in0 >= X.nbytes
    np.testing.assert_array_equal(back.array.numpy(), X)
    assert back.count == 300 and spilled.cache() is spilled
    np.testing.assert_array_equal(spilled.sample_per_shard(3).array.numpy(),
                                  X[[0, 149, 299]])


def test_a_fused_chain_takes_windows_of_a_source():
    """A fused chain over an out-of-core source runs window by window
    (its rows' result equal to the whole source's); a spilled input
    does the same."""
    X = _host_rows(700, dim=32)
    chain = FusedBatchTransformer([RandomSignNode(32, device="cpu"),
                                   LinearRectifier(0.0)], microbatch=64)
    want = chain.apply_batch(Dataset(X, device="cpu")).array
    src = _sharded(X, [0, 300, 700], OutOfCoreDataset, device="cpu")
    trips = counter("spill.window_trips").value
    with config_override(chunk_size=128):
        got = chain.apply_batch(src).array
        spilled = chain.apply_batch(SpilledDataset(X, device="cpu")).array
    assert counter("spill.window_trips").value - trips == 2 * 6
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(spilled, want)


# ------------------------------------------------- the planner's choice


def _data(n=4096, dim=64, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int32))


def _port_applied(X, y, **cfg):
    with config_override(unified_min_savings_seconds=0.0, **cfg):
        featurizer = (RandomSignNode(64, device="cpu").to_pipeline()
                      >> PaddedFFT() >> LinearRectifier(0.0))
        labels = ClassLabelIndicatorsFromInt(4)(Dataset(y, device="cpu"))
        data = Dataset(X, device="cpu")
        applied = (featurizer.and_then(
            BlockLeastSquaresEstimator(32, num_iter=1, lam=1e-3),
            data, labels) >> MaxClassifier())(data)
        applied.executor.optimized_graph  # optimized under this config
        return applied


def _jax_applied(X, y, **cfg):
    with jax_config(unified_min_savings_seconds=0.0, **cfg):
        featurizer = (JaxSign(64).to_pipeline() >> JaxFFT()
                      >> JaxRectifier(0.0))
        labels = JaxIndicators(4)(JaxDataset.from_numpy(y))
        data = JaxDataset.from_numpy(X)
        applied = (featurizer.and_then(JaxBLS(32, num_iter=1, lam=1e-3),
                                       data, labels) >> JaxMax())(data)
        applied.executor.optimized_graph
        return applied


def _markers(applied):
    g = applied.executor.optimized_graph
    return sorted((v.id, g.get_operator(v).placement) for v in g.operators
                  if type(g.get_operator(v)).__name__ == "CacheMarker")


def test_the_menu_prices_the_device_cache_inf_and_the_spill_feasible():
    """Under ``TIGHT`` the scored menu holds an INF device cache and a
    feasible spill of the same vertex, the plan spills, and each spill's
    prediction matches JAX's."""
    X, y = _data()
    app = _port_applied(X, y, hbm_budget_bytes=TIGHT)
    japp = _jax_applied(X, y, hbm_budget_bytes=TIGHT)
    specs, _ = spec_pass(app.executor.graph, {})
    jspecs, _ = jax_spec_pass(japp.executor.graph, {})
    plan = plan_unified(app.executor.graph, specs, hbm_budget_bytes=TIGHT,
                        include_boundary_policies=False, allow_spill=True)
    jplan = jax_plan_unified(japp.executor.graph, jspecs,
                             hbm_budget_bytes=TIGHT,
                             include_boundary_policies=False,
                             allow_spill=True)
    entries = {c["entry"]: c["feasible"] for c in plan.scored_candidates}
    assert entries == {c["entry"]: c["feasible"]
                       for c in jplan.scored_candidates}
    assert [e for e, ok in entries.items()
            if e.startswith("cache_") and not ok]
    assert [e for e, ok in entries.items()
            if e.startswith("spill_") and ok]
    assert plan.chosen.spills and plan.chosen.spills <= plan.chosen.caches
    assert sorted(v.id for v in plan.chosen.spills) == \
        sorted(v.id for v in jplan.chosen.spills)
    jpred = {v.id: p for v, p in jplan.spill_predictions.items()}
    for vid, pred in plan.spill_predictions.items():
        assert pred["bytes"] == jpred[vid.id]["bytes"] > 0
        assert pred["window_trips"] == jpred[vid.id]["window_trips"]
        assert pred["reload_seconds"] == pytest.approx(
            jpred[vid.id]["reload_seconds"], rel=0.05)


def test_the_host_cache_is_enforced_with_output_parity():
    """The optimized graph holds the host `CacheMarker`s JAX's holds, the
    run completes, its predictions agree with the unbudgeted run's and
    JAX's, and the ledger holds the ``spill`` record with its priced
    alternatives."""
    X, y = _data()
    base = _port_applied(X, y).get().array.numpy()
    PipelineEnv.reset()
    mark = ledger.session_mark()
    app = _port_applied(X, y, hbm_budget_bytes=TIGHT)
    japp = _jax_applied(X, y, hbm_budget_bytes=TIGHT)
    assert _markers(app) == _markers(japp)
    assert any(p == "host" for _, p in _markers(app))
    before = counter("spill.bytes_out").value
    out = app.get().array.numpy()
    assert counter("spill.bytes_out").value > before
    jout = np.asarray(japp.get().array)[: len(out)]
    assert out.shape == base.shape
    assert np.mean(out != base) < MAX_DISAGREE
    assert np.mean(out != jout) < MAX_DISAGREE
    spills = [d for d in ledger.session_since(mark) if d["kind"] == "spill"]
    assert spills
    rec = spills[0]
    assert rec["chosen"]["placement"] == "host"
    assert rec["chosen"]["spills"][0]["reload_seconds"] > 0
    assert any(a["entry"].startswith("cache_") and not a["feasible"]
               for a in rec["alternatives"])
    assert any(a["entry"].startswith("spill_") and a["feasible"]
               for a in rec["alternatives"])


def test_spill_off_gives_the_spill_free_plan():
    X, y = _data()
    app = _port_applied(X, y, hbm_budget_bytes=TIGHT, ooc_spill=False)
    assert not any(p == "host" for _, p in _markers(app))
    specs, _ = spec_pass(app.executor.graph, {})
    off = plan_unified(app.executor.graph, specs, hbm_budget_bytes=TIGHT,
                       include_boundary_policies=False, allow_spill=False)
    assert off.chosen.spills == frozenset()
    assert not [c for c in off.scored_candidates
                if c["entry"].startswith("spill_")]
    on = plan_unified(app.executor.graph, specs,
                      include_boundary_policies=False, allow_spill=True)
    off2 = plan_unified(app.executor.graph, specs,
                        include_boundary_policies=False, allow_spill=False)
    assert on.chosen.spills == frozenset()
    assert on.chosen == off2.chosen


def test_a_host_cache_marker_spills_and_passes_host_values():
    X = _host_rows(40, dim=4)
    marker = CacheMarker("x", placement="host")
    assert marker.label == "Cache[host:x]" and not marker.chunkable
    spilled = marker.batch_transform([Dataset(X, device="cpu")])
    assert spilled.is_spilled
    assert marker.batch_transform([spilled]) is spilled
    with pytest.raises(ValueError):
        CacheMarker("x", placement="disk")


def test_the_cifar_source_draws_each_shard_from_its_seed():
    """`synthetic_cifar_out_of_core`: shard i from seed + i, the labels
    drawn alone equal to the shards' own, two walks equal, CIFAR-shaped
    float32 rows on the templates `synthetic_cifar` draws from."""
    from keystone_tpu_torch.loaders.cifar_loader import (
        CifarShards,
        synthetic_cifar_out_of_core,
    )

    images, labels = synthetic_cifar_out_of_core(700, shard_rows=256,
                                                 seed=3, device="cpu")
    assert images.count == 700 and images.item_shape == (32, 32, 3)
    draws = CifarShards(seed=3)
    x1, y1 = draws.shard(256, 4)
    np.testing.assert_array_equal(images.row_loader(256, 512), x1)
    np.testing.assert_array_equal(labels.array.numpy()[256:512], y1)
    np.testing.assert_array_equal(images.row_loader(600, 700),
                                  images.row_loader(600, 700))
    assert x1.dtype == np.float32 and 100 < float(x1.mean()) < 160
