"""The port's parallel layer (`keystone_tpu_torch/parallel/`) over real
processes: gloo groups of 1, 2 and 4 ranks on the CPU.

Mirrors `tests/test_parallel.py`: the collectives, `init_multihost`,
`global_data_mesh`, `dataset_from_process_local` and the solvers that
all-reduce over the data axis, each held to JAX's one-device fit within
JAX's own ``atol=2e-3`` and to the port's one-process fit within 1e-4 of
max|W| (float32 sums over shards in another order), and bit-equal across
ranks (every rank factors the same all-reduced sums). A count the world
does not divide (1,001 rows) checks that padded rows change no moment,
Gram or confusion count. The ranks run in `tests/torch_parallel_worker.py`,
one job a world size shared by every pytest worker, each rank's group
with a 60 s timeout and the job killed at 180 s.
"""

import os

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBCD,
    DenseLBFGSwithL2 as JaxLBFGS,
    LinearMapEstimator as JaxLinear,
)
from keystone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from keystone_tpu.parallel.mesh import use_mesh as jax_use_mesh
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import (
    BlockLeastSquaresEstimator,
    DenseLBFGSwithL2,
    LinearMapEstimator,
)
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch import parallel
from keystone_tpu_torch.telemetry import counter, registry

import torch_parallel_worker as worker

WORLDS = (1, 2, 4)
#: JAX's tolerance between mesh shapes (tests/test_parallel.py)
JAX_ATOL = 2e-3
#: against the port's one-process fit, a share of max|W|
PORT_RTOL = 1e-4


def shared_root(tmp_path_factory) -> str:
    """A directory every pytest worker of this run sees."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return str(root)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    return request.param, worker.run_job(
        "collectives", request.param, shared_root(tmp_path_factory))


def _arrays(ranks, key):
    return [arr[key] for _, arr in ranks[1]]


def _same_on_every_rank(ranks, key):
    first, *rest = _arrays(ranks, key)
    for other in rest:
        np.testing.assert_array_equal(other, first)
    return first


def test_tree_reduce_sum_matches_numpy(ranks):
    x = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    got = _same_on_every_rank(ranks, "reduce_sum")
    np.testing.assert_allclose(got, x.sum(axis=0), rtol=1e-6)


def test_tree_aggregate_moments(ranks):
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "agg_sum"),
                               x.sum(axis=0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "agg_sumsq"),
                               (x * x).sum(axis=0), rtol=1e-5)
    assert all(res["agg_n"] == 64.0 for res, _ in ranks[1])


def test_broadcast_gives_rank_zeros_copy(ranks):
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "bcast"),
                                  np.ones((4, 4), np.float32))


def test_co_sharded_and_reshard(ranks):
    for res, arr in ranks[1]:
        assert res["co_sharded"] and not res["co_sharded_rep"]
        assert res["reshard_identity"]
        np.testing.assert_array_equal(arr["reshard_rep"],
                                      np.ones((16, 2), np.float32))
        np.testing.assert_array_equal(arr["reshard_back"],
                                      np.ones((16, 2), np.float32))


def test_all_gather_rows_replicates_full_axis(ranks):
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "gathered"),
        np.arange(32, dtype=np.float32).reshape(32, 1))


def test_init_multihost_noop_and_idempotent(ranks):
    assert all(res["init_noop"] and res["init_again"]
               for res, _ in ranks[1])


def test_global_data_mesh_axes(ranks):
    """`tests/test_parallel.py::test_global_data_mesh_axes`: the whole
    job on ``data``, and ``model_shards=2`` a (world/2, 2) mesh."""
    world = ranks[0]
    for res, _ in ranks[1]:
        assert res["mesh_axes"] == ["data"]
        assert res["data_shards"] == world
        assert res["current_is_default"]
        if world > 1:
            assert res["model_mesh"] == [["data", "model"], world // 2, 2]


def test_dataset_from_process_local(ranks):
    world = ranks[0]
    rows = _same_on_every_rank(ranks, "local_rows")
    np.testing.assert_array_equal(
        rows, np.arange(8 * world, dtype=np.float32).reshape(-1, 1))
    for res, _ in ranks[1]:
        assert res["local_count"] == 8 * world
        assert res["local_bad_count_raises"]


def _padded_problem():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1001, 6)).astype(np.float32)
    Y = (X @ rng.normal(size=(6, 3)) + 0.1 * rng.normal(size=(1001, 3))
         ).astype(np.float32)
    preds = rng.integers(0, 4, size=1001).astype(np.int64)
    actual = rng.integers(0, 4, size=1001).astype(np.int64)
    return X, Y, preds, actual


def test_padding_changes_no_moment_or_count(ranks):
    """1,001 rows over 1, 2 and 4 ranks: `numpy()` gives the 1,001 rows,
    the moments are those of the 1,001, the scaled padded rows are zero,
    and the confusion matrix counts the 1,001."""
    world = ranks[0]
    X, _, preds, actual = _padded_problem()
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "pad_numpy"), X)
    for res, _ in ranks[1]:
        assert res["pad_padded_count"] == -(-1001 // world) * world
        assert res["pad_valid"] == 1001.0
        assert res["pad_scaled_padded_rows_zero"]
    one = StandardScaler().fit(Dataset(X, device="cpu"))
    rel = PORT_RTOL
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_mean"),
                               one.mean.numpy(), rtol=rel, atol=1e-6)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_std"),
                               one.std.numpy(), rtol=rel)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_scaled"),
                               one.apply_batch(Dataset(X, device="cpu"))
                               .numpy(), rtol=0, atol=1e-5)
    # a fused chain re-zeroes padded rows after its scaler (JAX's
    # fuse_masks_output), and its rows are the one-process chain's
    from keystone_tpu_torch.nodes.learning.block_ls import BlockLinearMapper
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    W3 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 3)).astype(np.float32))
    chain = FusedBatchTransformer([one, BlockLinearMapper(W3, torch.ones(3))],
                                  microbatch=128)
    np.testing.assert_allclose(
        _same_on_every_rank(ranks, "pad_chain"),
        chain.apply_batch(Dataset(X, device="cpu")).numpy(), rtol=0,
        atol=1e-5)
    for res, _ in ranks[1]:
        assert res["pad_chain_padded_rows_are_b"]
    want = np.zeros((4, 4))
    np.add.at(want, (actual, preds), 1)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "pad_confusion"),
                                  want)


@pytest.mark.parametrize("key", ["pad_k4", "pad_k4_megafused"])
def test_padded_rows_through_a_planned_chain_kernel(ranks, key):
    """1,001 images through a chain that K4 plans, its scaler the last
    stage of the kernel's run, eagerly and megafused: the row mask goes
    into the kernel, so each rank's padded rows come out zero, and the
    1,001 rows are the plain chain's."""
    from keystone_tpu_torch.nodes.util.fusion import stage_fuse
    from keystone_tpu_torch.ops.chain_kernels import (
        elementwise_chain_reference,
    )

    chain = worker.k4_chain()
    fused = [stage_fuse(s) for s in chain.fused]
    want = elementwise_chain_reference(
        [f[0] for f in fused], [f[1] for f in fused],
        torch.from_numpy(worker.k4_images()))
    np.testing.assert_allclose(_same_on_every_rank(ranks, key), want.numpy(),
                               rtol=0, atol=1e-5)
    for res, _ in ranks[1]:
        assert res["pad_k4_planned"] == [0, 4, "elementwise_chain"]
        assert res[f"{key}_padded_rows_zero"]


def test_collectives_are_spans_under_a_tracer(ranks):
    """Under a tracer each collective is one ``collective`` span named by
    its kind, with its bytes: a broadcast of 2 floats, then an
    all-reduce of 5."""
    for res, _ in ranks[1]:
        assert res["collective_spans"] == [["broadcast", 8],
                                           ["all_reduce", 20]]


def _jax_fit(est, X, Y):
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        m = est.fit(JaxDataset(X), JaxDataset(Y))
    return np.asarray(m.W), np.asarray(m.b)


def _port_fit(est, X, Y):
    m = est.fit(Dataset(X, device="cpu"), Dataset(Y, device="cpu"))
    return m.W.numpy(), m.b.numpy()


def _hold(ranks, key, jax_wb, port_wb):
    """W and b bit-equal across ranks, within JAX's atol of JAX's
    one-device fit and within PORT_RTOL of max|W| of the port's
    one-process fit."""
    W = _same_on_every_rank(ranks, f"{key}_W")
    b = _same_on_every_rank(ranks, f"{key}_b")
    W = W[: jax_wb[0].shape[0]]
    np.testing.assert_allclose(W, jax_wb[0][: W.shape[0]], atol=JAX_ATOL)
    np.testing.assert_allclose(b, jax_wb[1], atol=JAX_ATOL)
    scale = float(np.abs(port_wb[0]).max())
    np.testing.assert_allclose(W, port_wb[0][: W.shape[0]], rtol=0,
                               atol=PORT_RTOL * scale)
    np.testing.assert_allclose(b, port_wb[1], rtol=0,
                               atol=PORT_RTOL * max(scale, 1.0))


def _solver_data(name):
    if name == "exact":
        rng = np.random.default_rng(1)
        X = rng.normal(size=(96, 6)).astype(np.float32)
        return X, X @ rng.normal(size=(6, 3)).astype(np.float32)
    if name == "bcd":
        rng = np.random.default_rng(7)
        X = rng.normal(size=(96, 24)).astype(np.float32)
        W = rng.normal(size=(24, 3)).astype(np.float32)
        return X, X @ W + 0.01 * rng.normal(size=(96, 3)).astype(np.float32)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 16)).astype(np.float32)
    return X, X @ rng.normal(size=(16, 2)).astype(np.float32)


SOLVERS = {
    "exact": (lambda: JaxLinear(lam=0.0), lambda: LinearMapEstimator(lam=0.0)),
    "bcd": (lambda: JaxBCD(block_size=8, num_iter=4, lam=0.1),
            lambda: BlockLeastSquaresEstimator(block_size=8, num_iter=4,
                                               lam=0.1)),
    "lbfgs": (lambda: JaxLBFGS(lam=0.5, num_iters=15),
              lambda: DenseLBFGSwithL2(lam=0.5, num_iters=15)),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solver_across_ranks(ranks, name):
    """`LinearMapEstimator` on JAX's 96×6, BCD (block 8, 4 epochs, λ 0.1)
    on JAX's 96×24, dense L-BFGS (λ 0.5, 15 steps) on JAX's 64×16."""
    X, Y = _solver_data(name)
    jax_est, port_est = SOLVERS[name]
    _hold(ranks, name, _jax_fit(jax_est(), X, Y),
          _port_fit(port_est(), X, Y))


PADDED_SOLVERS = {
    "pad_exact": (lambda: JaxLinear(lam=0.1),
                  lambda: LinearMapEstimator(lam=0.1)),
    "pad_bcd": (lambda: JaxBCD(2, 3, lam=0.1),
                lambda: BlockLeastSquaresEstimator(2, 3, lam=0.1)),
    "pad_lbfgs": (lambda: JaxLBFGS(lam=0.5, num_iters=15),
                  lambda: DenseLBFGSwithL2(lam=0.5, num_iters=15)),
}


@pytest.mark.parametrize("name", sorted(PADDED_SOLVERS))
def test_solver_at_a_count_the_world_does_not_divide(ranks, name):
    """The three solvers on 1,001 rows: padded rows reach no Gram."""
    X, Y, _, _ = _padded_problem()
    jax_est, port_est = PADDED_SOLVERS[name]
    _hold(ranks, name, _jax_fit(jax_est(), X, Y),
          _port_fit(port_est(), X, Y))


def test_solver_agrees_across_mesh_shapes(tmp_path_factory):
    """`tests/test_parallel.py`'s property: `LinearMapEstimator` on one
    rank and on four gives the same model."""
    root = shared_root(tmp_path_factory)
    one = worker.run_job("collectives", 1, root)
    four = worker.run_job("collectives", 4, root)
    np.testing.assert_allclose(four[0][1]["exact_W"], one[0][1]["exact_W"],
                               atol=1e-3)


def test_guard_raises_for_estimators_not_mesh_aware(ranks,
                                                    tmp_path_factory):
    """The ZCA whitener and the approximate PCA, which raised here
    before, fit every rank's rows of a multi-rank `Dataset`: each rank's
    whitener, means and components equal one process's (both collect
    the rows first). An estimator outside the package that is not marked
    ``mesh_aware`` (this test's own) still raises there, naming the
    class and no ROADMAP item, and fits on one rank."""
    one = worker.run_job("collectives", 1,
                         shared_root(tmp_path_factory))[0][1]
    for key in ("zca_whitener", "zca_means", "approx_pca"):
        np.testing.assert_array_equal(_same_on_every_rank(ranks, key),
                                      one[key])
    for res, _ in ranks[1]:
        assert res["guard_zca"] == res["guard_approx_pca"] == ""
        if ranks[0] == 1:
            assert res["guard_unmarked"] == ""
            continue
        assert "Unmarked is not mesh-aware" in res["guard_unmarked"]
        assert "ROADMAP" not in res["guard_unmarked"]


def test_per_process_dispatch_counters(ranks):
    """Each rank counts its own dispatches on ``p<rank>``."""
    for rank, (res, _) in enumerate(ranks[1]):
        assert res["counters"][f"p{rank}"] > 0
        assert all(v == 0 for k, v in res["counters"].items()
                   if k != f"p{rank}")


def test_one_process_has_no_mesh_and_no_collective():
    """Without a process group: no mesh, nothing padded, the collectives
    are identities and no ``p<i>`` counter appears."""
    assert parallel.current_mesh() is None
    assert parallel.n_data_shards() == 1
    assert parallel.init_multihost() == 1
    ds = Dataset(np.ones((5, 2), np.float32), device="cpu")
    assert ds.mesh is None and ds.padded_count == ds.count == 5
    assert bool(ds.mask.all()) and not ds.has_padding
    before = registry().snapshot()["counters"]
    t = torch.ones(3)
    assert parallel.all_reduce(t, None) is t
    assert parallel.broadcast(t) is t
    assert parallel.psum((t, t), None)[0] is t
    np.testing.assert_array_equal(parallel.tree_reduce_sum(ds).numpy(),
                                  [5.0, 5.0])
    after = registry().snapshot()["counters"]
    assert not any(k.startswith("collectives.") and after[k] != before.get(k)
                   for k in after)
    from keystone_tpu_torch.telemetry import instrument

    assert instrument.process_dim() is None
    instrument.record_dispatch()
    assert not any(k.startswith("dispatch.programs_executed.p")
                   for k in registry().snapshot()["counters"])


def test_per_process_dispatch_dimension(monkeypatch):
    """JAX's `tests/test_telemetry.py` test: a dispatch also lands on the
    per-process counter, and the dispatch summary renders it."""
    from keystone_tpu_torch.telemetry import instrument
    from keystone_tpu_torch.telemetry.export import dispatch_summary

    monkeypatch.setattr(instrument, "process_dim", lambda: "p1")
    before = counter("dispatch.programs_executed.p1").value
    instrument.record_dispatch(3)
    assert counter("dispatch.programs_executed.p1").value == before + 3
    trace = {"traceEvents": [],
             "keystone": {"metrics": registry().snapshot()}}
    line = dispatch_summary(trace)
    assert line is not None and "per-process: p1=" in line


def test_collective_cost_is_one_formula():
    """The unified planner prices boundary moves with `parallel/mesh.py`'s
    `collective_cost`, as JAX's planner and lints share one."""
    from keystone_tpu_torch.analysis import planner

    from keystone_tpu.parallel import mesh as jmesh

    assert planner.collective_cost is parallel.mesh.collective_cost
    assert planner.collective_cost("all_gather", 1 << 20, 1).bytes_moved == 0
    # over more than one shard: JAX's bytes (`tests/
    # test_torch_sharding_planner.py` holds every kind and count)
    assert parallel.mesh.collective_cost("all_gather", 1 << 20, 2) \
        .bytes_moved == jmesh.collective_cost("all_gather", 1 << 20, 2) \
        .bytes_moved == 1 << 20
    with pytest.raises(ValueError):
        parallel.mesh.collective_cost("shuffle", 1, 1)


def test_spec_helpers_match_jax():
    from keystone_tpu.parallel import mesh as jmesh
    from jax.sharding import PartitionSpec as JP

    P = parallel.P
    for spec, jspec in ((P(), JP()), (P("data"), JP("data")),
                        (P("data", None), JP("data", None)),
                        (P(("data", "model")), JP(("data", "model")))):
        assert parallel.spec_axes(spec) == jmesh.spec_axes(jspec)
    assert parallel.specs_equal(P("data"), P("data", None))
    assert not parallel.specs_equal(P("data"), P())
    assert parallel.spec_shards(P("data")) == 1  # no mesh: one shard
