"""The cost-model solver choice: the port against the JAX package.

- Every cost model's value equals JAX's within rtol 1e-12 on the same
  profile and the same weights passed in: the three routing shapes of
  `tests/test_solvers.py:301-311`, PCA at d = 128 around the n = 132/133
  crossover, 1 and 16 devices, JAX's analytic weights and a second set.
- `LeastSquaresEstimator.chosen` and `ColumnPCAEstimator.chosen` equal
  JAX's on that grid (JAX on a one-device mesh; its PCA choice reads
  resolved weights, so both packages' resolution returns the same
  tuple there).
- `calibrate_cost_weights` on the CPU at small probe sizes gives finite,
  positive weights; a calibration file applies only on the device it
  was measured on, or under ``KEYSTONE_COST_CALIBRATION=force``.
- The port's VOCSIFTFisher graph chooses JAX's PCA route at the tests'
  small configuration.
"""

import json

import numpy as np
import pytest

import jax

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.dataset import HostDataset as JaxHostDataset
from keystone_tpu.nodes.learning import cost_model as jax_cost_model
from keystone_tpu.nodes.learning import pca as jax_pca
from keystone_tpu.nodes.learning.least_squares import (
    LeastSquaresEstimator as JaxLeastSquares,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import voc_sift_fisher as jax_voc
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.learning import calibrate, cost_model, pca
from keystone_tpu_torch.nodes.learning.least_squares import (
    LeastSquaresEstimator,
)
from keystone_tpu_torch.pipelines import voc_sift_fisher as voc

COST_RTOL = 1e-12
# JAX's analytic weights (what it resolves on the CPU) and a second set
# of the order the card's probes give
WEIGHTS = [(5e-15, 1.25e-12, 1e-11), (2.0e-14, 3.3e-13, 2.2e-12)]
# (n, d, k, sparsity): tests/test_solvers.py:301-311
ROUTING_SHAPES = [(2_000_000, 128, 10, 1.0), (100_000, 16384, 2, 1.0),
                  (5_000_000, 16384, 2, 0.004)]
CHIPS = [1, 16]


def _models(jax_side: bool):
    cm = jax_cost_model if jax_side else cost_model
    p = jax_pca if jax_side else pca
    return [cm.ExactSolverCostModel(), cm.BlockSolverCostModel(4096, 3),
            cm.LBFGSCostModel(20, sparse=False),
            cm.LBFGSCostModel(20, sparse=True), p.LocalPCACostModel(),
            p.DistributedPCACostModel()]


PROFILES = [s + (c,) for s in ROUTING_SHAPES for c in CHIPS] + [
    (n, 128, 16, 1.0, c) for n in (132, 133, 10_000) for c in CHIPS]


@pytest.mark.parametrize("profile", PROFILES, ids=str)
@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
def test_every_cost_model_equals_jax(profile, weights):
    n, d, k, sparsity, chips = profile
    jp = jax_cost_model.CostProfile(n, d, k, sparsity, chips)
    tp = cost_model.CostProfile(n, d, k, sparsity, chips)
    for jm, tm in zip(_models(True), _models(False)):
        want, got = jm.cost(jp, *weights), tm.cost(tp, *weights)
        assert got == pytest.approx(want, rel=COST_RTOL), type(tm).__name__


def _dense_sample(d, k, sparsity, seed=0):
    """tests/test_solvers.py:284-297's sample: 64 rows, masked to the
    density, and 64 label rows."""
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=(64, d)).astype(np.float32)
    if sparsity < 1.0:
        arr = (arr * (rng.random(arr.shape) < sparsity)).astype(np.float32)
    return arr, rng.normal(size=(64, k)).astype(np.float32)


@pytest.mark.parametrize("shape", ROUTING_SHAPES, ids=str)
@pytest.mark.parametrize("chips", CHIPS)
@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
def test_least_squares_choice_equals_jax(shape, chips, weights):
    n, d, k, sparsity = shape
    X, Y = _dense_sample(d, k, sparsity)
    with use_mesh(make_mesh(jax.devices()[:1])):
        jest = JaxLeastSquares(num_chips=chips, cpu_weight=weights[0],
                               mem_weight=weights[1],
                               network_weight=weights[2])
        jest.optimize(JaxDataset(X), JaxDataset(Y), max(n // chips, 1))
    est = LeastSquaresEstimator(num_chips=chips, cpu_weight=weights[0],
                                mem_weight=weights[1],
                                network_weight=weights[2])
    est.optimize(Dataset(X, device="cpu"), Dataset(Y, device="cpu"),
                 max(n // chips, 1))
    assert est.chosen == jest.chosen
    assert set(est.costs) == {"dense-lbfgs", "sparse-lbfgs", "block-ls",
                              "exact"}


def test_least_squares_routes_as_the_jax_suite():
    """JAX's own routing expectations (tests/test_solvers.py:301-311)
    hold for the port under JAX's analytic weights."""
    def route(n, d, k, sparsity):
        X, Y = _dense_sample(d, k, sparsity)
        est = LeastSquaresEstimator(num_chips=8, cpu_weight=WEIGHTS[0][0],
                                    mem_weight=WEIGHTS[0][1],
                                    network_weight=WEIGHTS[0][2])
        est.optimize(Dataset(X, device="cpu"), Dataset(Y, device="cpu"),
                     max(n // 8, 1))
        return est.chosen

    assert route(2_000_000, 128, 10, 1.0) == "exact"
    assert route(100_000, 16384, 2, 1.0) in ("block-ls", "dense-lbfgs")
    assert route(5_000_000, 16384, 2, 0.004) == "sparse-lbfgs"


@pytest.fixture
def same_weights(monkeypatch):
    """Both packages resolve the given (cpu, mem, network) weights."""
    def use(weights):
        monkeypatch.setattr(jax_cost_model, "_resolve_weights",
                            lambda: weights)
        monkeypatch.setattr(cost_model, "resolve_weights", lambda: weights)
    return use


@pytest.mark.parametrize("n", [100, 132, 133, 200, 10_000])
@pytest.mark.parametrize("chips", CHIPS)
@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
@pytest.mark.parametrize("form", ["vectors", "descriptor_matrices"])
def test_column_pca_choice_equals_jax(same_weights, n, chips, weights, form):
    same_weights(weights)
    rng = np.random.default_rng(1)
    if form == "vectors":
        rows = rng.normal(size=(3, 128)).astype(np.float32)
        jax_sample, sample, per_shard = (JaxDataset(rows),
                                         Dataset(rows, device="cpu"), n)
    else:
        items = [rng.normal(size=(4, 128)).astype(np.float32)
                 for _ in range(3)]
        jax_sample = JaxHostDataset(items)
        sample = HostDataset(items, device="cpu")
        per_shard = max(n // 4, 1)
    with use_mesh(make_mesh(jax.devices()[:1])):
        jest = jax_pca.ColumnPCAEstimator(16, num_chips=chips)
        jest.optimize(jax_sample, per_shard)
    est = pca.ColumnPCAEstimator(16, num_chips=chips)
    chosen = est.optimize(sample, per_shard)
    assert est.chosen == jest.chosen
    assert type(chosen).__name__ == {
        "local": "PCAEstimator",
        "distributed": "DistributedPCAEstimator"}[est.chosen]


def test_column_pca_crossover_on_one_device(same_weights):
    """Under JAX's analytic weights on one device at d = 128 local PCA
    wins up to n = 132 rows and distributed from n = 133."""
    same_weights(WEIGHTS[0])
    rows = np.zeros((3, 128), np.float32)
    for n, want in ((132, "local"), (133, "distributed")):
        est = pca.ColumnPCAEstimator(16)
        est.optimize(Dataset(rows, device="cpu"), n)
        assert est.chosen == want


def test_voc_graph_chooses_jax_pca_route(monkeypatch):
    """At the parity tests' small VOC configuration the port's
    VOCSIFTFisher graph prices PCA on the sample its optimizer draws and
    takes the route JAX's graph takes (both on one device, under the
    weights each package resolves on the CPU: JAX's analytic ones)."""
    cfg = dict(n_synth=30, num_classes=4, gmm_k=4, pca_dims=16)
    seen = {}

    def spy(cls, key):
        original = cls.optimize

        def optimize(self, sample, num_per_shard):
            out = original(self, sample, num_per_shard)
            seen[key] = (self.chosen, num_per_shard)
            return out
        monkeypatch.setattr(cls, "optimize", optimize)

    spy(jax_pca.ColumnPCAEstimator, "jax")
    spy(pca.ColumnPCAEstimator, "port")
    monkeypatch.setattr(cost_model, "resolve_weights",
                        lambda: jax_cost_model._resolve_weights())
    with use_mesh(make_mesh(jax.devices()[:1])):
        jax_voc.run(jax_voc.VOCSIFTFisherConfig(**cfg))
    voc.run(voc.VOCSIFTFisherConfig(**cfg), device="cpu")
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "distributed"


def test_calibrate_cost_weights_on_the_cpu():
    w = calibrate.calibrate_cost_weights(device="cpu", gemm_dim=128,
                                         mem_mb=4, iters=2)
    for v in (w.cpu_weight, w.mem_weight, w.network_weight, w.host_bw,
              w.peak_flops, w.peak_bw):
        assert np.isfinite(v) and v > 0
    assert w.peak_flops == pytest.approx(1.0 / w.cpu_weight)
    p = cost_model.CostProfile(n=10_000, d=128, k=4, sparsity=1.0,
                               num_chips=1)
    cost = cost_model.ExactSolverCostModel().cost(
        p, w.cpu_weight, w.mem_weight, w.network_weight)
    assert np.isfinite(cost) and cost > 0
    est = LeastSquaresEstimator.calibrated(
        lam=1.0, probe_kwargs=dict(device="cpu", gemm_dim=64, mem_mb=1,
                                   iters=2))
    assert min(est.cpu_weight, est.mem_weight, est.network_weight) > 0


@pytest.fixture
def calibration(monkeypatch, tmp_path):
    """A calibration file at a temporary path standing for the committed
    one; returns a writer (platform → the payload's weights)."""
    path = tmp_path / "cal.json"
    monkeypatch.setattr(cost_model, "CALIBRATION_FILE", str(path))
    monkeypatch.setattr(cost_model, "_weights_cache", None)
    monkeypatch.delenv("KEYSTONE_COST_CALIBRATION", raising=False)

    def write(platform):
        weights = calibrate.CostWeights(1e-13, 2e-12, 3e-11, host_bw=5e9)
        calibrate.write_calibration(str(path), weights,
                                    {"platform": platform})
        return (1e-13, 2e-12, 3e-11)
    return write


def test_a_file_from_another_device_applies_only_under_force(
        calibration, monkeypatch):
    want = calibration("NVIDIA H100 80GB HBM3")
    assert cost_model.live_platform() == "cpu"
    assert cost_model.resolve_weights() == cost_model.ANALYTIC_CPU
    assert calibrate.host_bandwidth() == calibrate.CPU_HOST_BW
    assert calibrate.machine_rates() == (cost_model.CPU_PEAK_FLOPS,
                                         cost_model.CPU_PEAK_BW)
    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", "force")
    assert cost_model.resolve_weights() == want
    assert calibrate.host_bandwidth() == 5e9
    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", "analytic")
    assert cost_model.resolve_weights() == cost_model.ANALYTIC_CPU


def test_a_file_from_the_live_device_applies(calibration, monkeypatch):
    want = calibration("cpu")
    assert cost_model.resolve_weights() == want
    assert cost_model.CPU_WEIGHT == want[0]
    assert calibrate.default_weights().mem_weight == want[1]
    assert calibrate.machine_rates() == (1.0 / want[0], 1.0 / want[1])


def test_a_calibration_path_is_read_with_the_platform_check(
        calibration, monkeypatch, tmp_path, caplog):
    calibration("NVIDIA H100 80GB HBM3")
    other = tmp_path / "other.json"
    calibrate.write_calibration(str(other), calibrate.CostWeights(
        4e-13, 5e-12, 6e-11), {"platform": "cpu"})
    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", str(other))
    assert cost_model.resolve_weights() == (4e-13, 5e-12, 6e-11)
    missing = tmp_path / "missing.json"
    monkeypatch.setenv("KEYSTONE_COST_CALIBRATION", str(missing))
    with caplog.at_level("WARNING"):
        assert cost_model.resolve_weights() == cost_model.ANALYTIC_CPU
    assert "does not exist" in caplog.text


def test_the_committed_calibration_names_the_card():
    """The committed file was measured on the card: its provenance names
    the device and its power limit, and on the CPU it does not apply."""
    with open(cost_model.CALIBRATION_FILE) as f:
        cal = json.load(f)
    prov = cal["provenance"]
    assert prov["platform"].startswith("NVIDIA")
    assert "W" in prov["nvidia_smi"] and prov["torch"]
    assert cal["network_weight_measured"] is False
    assert prov["platform"] != cost_model.live_platform()
    assert cost_model.analytic_weights("cpu") == cost_model.ANALYTIC_CPU
    assert cost_model.analytic_weights(prov["platform"]) == \
        cost_model.ANALYTIC_CUDA
