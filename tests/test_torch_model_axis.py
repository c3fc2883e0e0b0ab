"""The model axis over real processes: gloo groups on the CPU laid out as
``(data, model)`` meshes (1, 2) and (2, 2).

Mirrors the model-axis cases of `tests/test_parallel.py` and of
`tests/test_sharding.py`/`tests/test_planner.py` that run on live data:
`Dataset`'s column tiles and their reshards, the runtime placement of
every boundary against the port's `sharding_pass`, a rank's tile bytes
against `per_device_pass`, the solvers (BCD, exact, dense L-BFGS) held
to JAX's one-device fit within JAX's ``atol=2e-3`` and to the port's
one-process fit within 1e-4 of max|W|, bit-equal across ranks,
RandomPatchCifar (16 filters, 601/201 images) staged and fused within
0.005 of JAX's accuracy, a stage that is not model-aware taking its
input by one model-axis all-gather, and `ShardingPlannerRule`'s
enforcement with outputs equal to the serial unfused plan's. The ranks
run `tests/torch_parallel_worker.py::model_job`, one group a mesh
shared by every pytest worker.
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.stats import StandardScaler

import torch_parallel_worker as worker
from test_torch_multihost import N_TRAIN, reference  # noqa: F401
from test_torch_parallel import (
    PADDED_SOLVERS,
    PORT_RTOL,
    SOLVERS,
    _hold,
    _jax_fit,
    _padded_problem,
    _port_fit,
    _same_on_every_rank,
    _solver_data,
)

#: world size → mesh: 2 ranks are (1, 2), 4 ranks (2, 2)
WORLDS = (2, 4)


@pytest.fixture(scope="module", params=WORLDS,
                ids=lambda w: f"mesh{w // 2}x2")
def ranks(request, reference):  # noqa: F811
    return request.param, worker.run_job("model", request.param,
                                         reference["root"])


def _placement_rows(ranks):
    first = ranks[1][0][0]["placement_rows"]
    for res, _ in ranks[1][1:]:
        assert [r[:2] for r in res["placement_rows"]] == \
            [r[:2] for r in first]
    return first


def test_global_mesh_is_data_by_model(ranks):
    world = ranks[0]
    for res, _ in ranks[1]:
        assert res["mesh_axes"] == ["data", "model"]
        assert res["shards"] == [world // 2, 2]


def test_dataset_tiles_and_numpy_round_trip(ranks):
    """A 16×8 matrix is each rank's (rows, 4) tile, columns by model
    rank; `numpy()` gathers both axes; images and a width the model axis
    does not divide stay model-replicated; every reshard round-trips."""
    world = ranks[0]
    X = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    rows = 16 // (world // 2)
    for rank, (res, arr) in enumerate(ranks[1]):
        d, m = divmod(rank, 2)
        assert res["tile"] == [[rows, 4], True, 8, 4 * m,
                               "P('data', 'model')"]
        np.testing.assert_array_equal(
            arr["tile_rows"], X[d * rows:(d + 1) * rows, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(arr["tile_numpy"], X)
        assert res["replicated_over_model"] == [False, "P('data',)",
                                                False, "P('data',)"]
        assert res["reshard"] == {
            "data": ["P('data',)", [rows, 8]],
            "none": ["P()", [16, 8]],
            "model": ["P(None, 'model')", [16, 4]],
            "data_model": ["P('data', 'model')", [rows, 4]]}
        assert res["reshard_identity"]
        assert res["card_transport_equal"]
        for name in ("data", "none", "model", "data_model"):
            np.testing.assert_array_equal(arr[f"reshard_{name}"], X)
            np.testing.assert_array_equal(arr[f"reshard_{name}_back"], X)


def test_propagation_matches_runtime_placement(ranks):
    """JAX's `test_propagation_matches_runtime_placement`: every stage's
    output, forced on the mesh, holds the spec `sharding_pass` predicts
    for it on the mesh's layout (61 rows, 16 wide, 10 classes)."""
    rows = _placement_rows(ranks)
    assert rows[0][1] == "P('data', 'model')"
    for label, runtime, _, (static, _), _, equal in rows[1:]:
        assert equal, (label, runtime, static)
    assert [r[1] for r in rows[1:]] == [
        "P('data', 'model')", "P('data', 'model')", "P('data', 'model')",
        "P('data',)"]


def test_per_device_static_matches_observed_shard_bytes(ranks):
    """JAX's `test_per_device_static_matches_observed_shard_bytes`: a
    rank's bytes of each stage's output equal `per_device_bytes` of its
    propagated spec (61 rows: the data shards pad them)."""
    for res, _ in ranks[1]:
        for label, _, observed, (_, static), _, _ in \
                res["placement_rows"][1:]:
            assert observed == static, (label, observed, static)
        # and through a trace, as JAX's test reads it: the executor's
        # static per-device bytes against the rank's observed ones
        assert res["trace_rows"]
        for label, static, observed, spec in res["trace_rows"]:
            assert static == observed == res["trace_shard_bytes"], label
            assert spec == "P('data', 'model')", label
        per_device, fleet = res["trace_peaks"]
        assert per_device and per_device <= fleet


def test_stage_not_model_aware_gathers_by_one_all_gather(ranks):
    """`MaxClassifier` reads 10-class scores held as 5-column tiles
    through one model-axis all-gather (GSPMD's inserted gather in JAX),
    and the chain's result equals one process's."""
    rows = _placement_rows(ranks)
    assert rows[-1][0] == "MaxClassifier"
    for res, _ in ranks[1]:
        assert res["placement_rows"][-1][4] == [1, 0]
        # a model-aware mapper reduces its partial product instead
        assert res["placement_rows"][3][4] == [0, 1]
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "placement_out"),
        ranks[1][0][1]["placement_one"])


def test_scaler_on_a_tile(ranks):
    """The moments of 1,001 rows from each rank's columns, gathered over
    model: those of one process."""
    X, _, _, _ = _padded_problem()
    one = StandardScaler().fit(Dataset(X, device="cpu"))
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_mean"),
                               one.mean.numpy(), rtol=PORT_RTOL, atol=1e-6)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_std"),
                               one.std.numpy(), rtol=PORT_RTOL)
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pad_scaled"),
                               one.apply_batch(Dataset(X, device="cpu"))
                               .numpy(), rtol=0, atol=1e-5)
    assert all(res["pad_scaled_tiled"] for res, _ in ranks[1])


def _hold_solver(ranks, name, table, data):
    jax_est, port_est = table[name]
    X, Y = data
    _hold(ranks, name, _jax_fit(jax_est(), X, Y),
          _port_fit(port_est(), X, Y))


def test_bcd_on_2d_mesh(ranks):
    """BCD (block 8, 4 epochs, λ 0.1) on JAX's 96×24, each block gathered
    over model as it is used; and at 1,001 rows (blocks of 2)."""
    _hold_solver(ranks, "bcd", SOLVERS, _solver_data("bcd"))
    X, Y, _, _ = _padded_problem()
    _hold_solver(ranks, "pad_bcd", PADDED_SOLVERS, (X, Y))
    assert all(res["bcd_model_gathers"] == 0 for res, _ in ranks[1])


def test_exact_and_lbfgs_on_2d_mesh(ranks):
    """The normal equations (features gathered over model once) and
    dense L-BFGS (the objective on the tile: the partial X·W all-reduced
    over model) on JAX's problems and at 1,001 rows. JAX's own 2-D
    L-BFGS diverges on some backends (`tests/test_parallel.py:172-215`),
    so the port is held to JAX on one device."""
    _hold_solver(ranks, "exact", SOLVERS, _solver_data("exact"))
    _hold_solver(ranks, "lbfgs", SOLVERS, _solver_data("lbfgs"))
    X, Y, _, _ = _padded_problem()
    _hold_solver(ranks, "pad_exact", PADDED_SOLVERS, (X, Y))
    _hold_solver(ranks, "pad_lbfgs", PADDED_SOLVERS, (X, Y))
    for res, _ in ranks[1]:
        assert res["exact_model_gathers"] == 1
        assert res["lbfgs_model_gathers"] > 0


def test_solver_agrees_across_mesh_shapes(reference):  # noqa: F811
    """`tests/test_parallel.py`'s property across the model axis: the
    exact fit on (1, 2) and on (2, 2) gives one model."""
    two = worker.run_job("model", 2, reference["root"])
    four = worker.run_job("model", 4, reference["root"])
    np.testing.assert_allclose(four[0][1]["exact_W"], two[0][1]["exact_W"],
                               atol=1e-3)


@pytest.mark.parametrize("key", ["staged_W", "staged_b", "fused_W",
                                 "fused_b", "run_fused_W", "staged_preds",
                                 "filters"])
def test_cifar_bit_equal_across_ranks(ranks, key):
    _same_on_every_rank(ranks, key)


def test_random_patch_cifar_staged_on_the_model_axis(ranks, reference):  # noqa: F811
    """The staged pipeline on JAX's draws: test accuracy within 0.005 of
    JAX's one-device score, predictions equal to the one-process port's
    on at least 99.5% of the rows, W within 1e-4 of its max|W|; the
    predictions are P('data') (MaxClassifier gathered its scores)."""
    for res, _ in ranks[1]:
        acc = res["staged_test_accuracy"]
        assert abs(acc - reference["jax_acc"]) <= 0.005, (
            acc, reference["jax_acc"])
        assert res["staged_pred_spec"] == "P('data',)"
        assert res["staged_model_gathers"] >= 1
    preds = _same_on_every_rank(ranks, "staged_preds")
    assert float(np.mean(preds == reference["preds"])) >= 0.995
    W = _same_on_every_rank(ranks, "staged_W")
    np.testing.assert_allclose(W, reference["W"], rtol=0,
                               atol=1e-4 * float(np.abs(reference["W"]).max()))


def test_random_patch_cifar_fused_on_the_model_axis(ranks, reference):  # noqa: F811
    """`fused_fit` with BCD on each rank's column tile: accuracy within
    0.005 of JAX's, W within 1e-4 of max|W| of one process's (and of
    JAX's 2e-3 band); `run_staged` scores the 601 rows and `run_fused`
    lands in the staged band."""
    for res, _ in ranks[1]:
        acc = res["fused_test_accuracy"]
        assert abs(acc - reference["jax_acc"]) <= 0.005, (
            acc, reference["jax_acc"])
        assert res["run_staged_total"] == N_TRAIN
        assert 0.5 <= res["run_fused_test_accuracy"] <= 1.0
    W = _same_on_every_rank(ranks, "fused_W")
    scale = float(np.abs(reference["fused_W"]).max())
    np.testing.assert_allclose(W, reference["fused_W"], rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("n", [64, 43])
def test_planner_enforces_and_outputs_match_serial_unfused(ranks, n):
    """JAX's `test_planner.py` case on the mesh: the sharding planner
    finds a win, enforces it (a tagged program or a re-seeded input),
    and the outputs equal the serial unfused plan's, at a row count the
    data shards divide and at one they do not."""
    for res, arr in ranks[1]:
        assert res[f"planner_{n}_enforced"] == 1
        assert res[f"planner_{n}_tagged"] or any(
            spec != "P('data', 'model')"
            for spec in res[f"planner_{n}_reseeded"])
        np.testing.assert_allclose(arr[f"planner_{n}"], arr[f"serial_{n}"],
                                   rtol=1e-5, atol=1e-5)
    assert _same_on_every_rank(ranks, f"planner_{n}").shape == (n,)


def test_kill_switch_reproduces_the_plan_bit_for_bit(ranks):
    """JAX's `test_kill_switch_reproduces_pr8_plan_bit_for_bit`: with
    ``sharding_planner`` off, and with an optimizer built without the
    rule, the optimized plan is the same (vertices, operator classes,
    dependencies), carries no planner tag and keeps the caller's own
    datasets; with it on, the plan differs."""
    for res, _ in ranks[1]:
        off, off_own = res["kill_switch"]
        ctor, ctor_own = res["kill_switch_ctor"]
        on, _ = res["planner_on"]
        assert off == ctor
        assert all(row[3] == "None" for row in off)
        assert off_own and ctor_own
        assert on != off


def test_one_process_has_no_tile():
    """Without a group a 2-D dataset keeps every column and its spec is
    replicated; `gather_model` and `reshard` are identities."""
    from keystone_tpu_torch.parallel import P

    ds = Dataset(torch.ones(6, 4), device="cpu")
    assert not ds.tiled and ds.width == 4 and repr(ds.spec) == "P()"
    assert ds.gather_model() is ds
    assert ds.reshard(P("data", "model")) is ds
