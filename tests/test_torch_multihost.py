"""RandomPatchCifar fitted data-parallel over gloo ranks on the CPU, its
distributed checkpoint, and the launcher's multi-host flags.

The slice end to end at a small width (16 filters, two 64-wide BCD
blocks, 601/201 `synthetic_cifar` images, so that 2 and 4 ranks hold
padded rows: the masked moments, BCD and confusion counts, the patch
draws from uneven shards and the staged chain's masked loop all run) on
2 and on 4 ranks (`tests/torch_parallel_worker.py::cifar_job`). JAX's patch draws for the
seed are recomputed here and carried across (the RNG ground rule), so
`learn_filters_from_indices` on the mesh is held to JAX's filters and
whitener (2e-5, as `tests/test_torch_nodes.py` holds one process); the
fit then runs on the filters learned on the mesh. Held: the staged test
accuracy within 0.005 of JAX's one-device CPU score and `fused_fit`'s
within 0.005 of it; predictions equal to the one-process port's on at
least 99.5% of the test rows; W within 1e-4 of max|W| of the one-process
port's (float32 sums over ranks in another order); filters, whitener and
W bit-equal across ranks. A 2-rank `torch.distributed.checkpoint` save
and load predicts alike, and a corrupted sidecar is refused.
"""

import os

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import (
    MulticlassClassifierEvaluator as JaxEvaluator,
)
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.util import MaxClassifier as JaxMax
from keystone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from keystone_tpu.parallel.mesh import use_mesh as jax_use_mesh
from keystone_tpu.pipelines.random_patch_cifar import (
    RandomPatchCifarConfig as JaxConfig,
    run_staged as jax_run_staged,
)
from keystone_tpu_torch import __main__ as launcher
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
from keystone_tpu_torch.workflow import PipelineEnv

import torch_parallel_worker as worker
from test_torch_parallel import shared_root

CFG = worker.CIFAR_CFG
N_TRAIN, N_TEST = worker.CIFAR_N
WORLDS = (2, 4)


def _jax_draws(config):
    """The indices JAX's `learn_filters` draws for ``config.seed``."""
    n_sample, total, m = rpc.filter_sample_sizes(N_TRAIN, 32, 32, config)
    k_img, k_patch, k_filt = jax.random.split(
        jax.random.PRNGKey(config.seed), 3)
    _, img_idx = jax.lax.top_k(jax.random.uniform(k_img, (N_TRAIN,)),
                               n_sample)
    patch_idx = jax.random.randint(k_patch, (m,), 0, total)
    _, filt_idx = jax.lax.top_k(jax.random.uniform(k_filt, (m,)),
                                config.num_filters)
    return {k: np.asarray(v, np.int64) for k, v in
            (("img_idx", img_idx), ("patch_idx", patch_idx),
             ("filter_idx", filt_idx))}


def _make_reference(out_dir):
    """JAX's draws and one-device fit, and the one-process port's fit on
    the same arrays and draws, into ``out_dir``."""
    config = rpc.RandomPatchCifarConfig(**CFG)
    draws = _jax_draws(config)
    np.savez(os.path.join(out_dir, "draws.npz"), **draws)
    jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2, confusion=0.6)
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        _, _, parts = jax_run_staged(jtrain, JaxConfig(**CFG),
                                     JaxEvaluator(10))
        jpred = JaxMax().apply_batch(parts["model"].apply_batch(
            parts["scaler"].apply_batch(parts["featurizer"].apply_batch(
                jtest.data)))).numpy()

    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    filters, whitener = rpc.learn_filters_from_indices(
        train.data.array, *(torch.from_numpy(draws[k]) for k in
                            ("img_idx", "patch_idx", "filter_idx")),
        config.patch_size, config.patch_steps)
    PipelineEnv.reset()
    predictor = rpc.build_pipeline(train, config, learned=(filters, whitener))
    fW, _, _, _, _ = rpc.fused_fit(train, test, filters, whitener, config)
    np.savez(os.path.join(out_dir, "reference.npz"),
             jax_filters=np.asarray(parts["filters"]),
             jax_whitener=np.asarray(parts["whitener"].whitener),
             jax_means=np.asarray(parts["whitener"].means),
             jax_acc=np.float64(np.mean(jpred == jtest.labels.numpy())),
             preds=predictor(test.data).get().numpy(),
             W=predictor.fitted(1).W.numpy(), fused_W=fW.numpy())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """JAX's one-device fit and the one-process port's, made once for
    every pytest worker."""
    root = shared_root(tmp_path_factory)
    ref = worker.once(root, "cifar-reference", _make_reference)
    out = dict(np.load(os.path.join(ref, "reference.npz")))
    out["jax_acc"] = float(out["jax_acc"])
    out["root"] = root
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, reference):
    return request.param, worker.run_job("cifar", request.param,
                                         reference["root"])


def _same_on_every_rank(ranks, key):
    first, *rest = [arr[key] for _, arr in ranks[1]]
    for other in rest:
        np.testing.assert_array_equal(other, first)
    return first


def test_filters_on_the_mesh_match_jax(ranks, reference):
    for key in ("means", "whitener", "filters"):
        np.testing.assert_allclose(_same_on_every_rank(ranks, key),
                                   reference[f"jax_{key}"], atol=2e-5)


@pytest.mark.parametrize("key", ["staged_W", "staged_b", "fused_W",
                                 "fused_b", "own_filters", "own_whitener",
                                 "run_fused_W", "staged_preds"])
def test_bit_equal_across_ranks(ranks, key):
    _same_on_every_rank(ranks, key)


def test_staged_fit_against_jax_and_one_process(ranks, reference):
    acc = ranks[1][0][0]["staged_test_accuracy"]
    assert abs(acc - reference["jax_acc"]) <= 0.005, (acc,
                                                      reference["jax_acc"])
    preds = _same_on_every_rank(ranks, "staged_preds")
    assert float(np.mean(preds == reference["preds"])) >= 0.995
    W = _same_on_every_rank(ranks, "staged_W")
    np.testing.assert_allclose(W, reference["W"], rtol=0,
                               atol=1e-4 * float(np.abs(reference["W"]).max()))


def test_fused_fit_against_jax_and_one_process(ranks, reference):
    conf = _same_on_every_rank(ranks, "fused_conf_test")
    assert conf.sum() == N_TEST
    acc = float(np.trace(conf)) / N_TEST
    assert abs(acc - reference["jax_acc"]) <= 0.005, (acc,
                                                      reference["jax_acc"])
    W = _same_on_every_rank(ranks, "fused_W")
    scale = float(np.abs(reference["fused_W"]).max())
    np.testing.assert_allclose(W, reference["fused_W"], rtol=0,
                               atol=1e-4 * scale)


def test_run_staged_and_run_fused_on_the_mesh(ranks):
    """`run_staged` scores the 601 training rows over the ranks;
    `run_fused` (the port's own draws) lands in the staged band."""
    for res, _ in ranks[1]:
        assert res["run_staged_total"] == N_TRAIN
        assert 0.5 <= res["run_fused_test_accuracy"] <= 1.0


def test_distributed_checkpoint_predicts_alike(ranks):
    """A `format="dcp"` save and load of the fitted pipeline over the
    ranks gives the same predictions, the staged ones."""
    before = _same_on_every_rank(ranks, "ckpt_before")
    after = _same_on_every_rank(ranks, "ckpt_after")
    np.testing.assert_array_equal(before, after)
    np.testing.assert_array_equal(before,
                                  _same_on_every_rank(ranks, "staged_preds"))


def test_corrupted_sidecar_is_refused(ranks):
    for res, _ in ranks[1]:
        assert "torn checkpoint" in res["corrupt_sidecar"]


def test_checkpoint_in_one_process(tmp_path):
    """Without a group the distributed format still round-trips."""
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    config = rpc.RandomPatchCifarConfig(**CFG)
    train, test = synthetic_cifar(200, 50, noise=1.2, confusion=0.6,
                                  device="cpu")
    PipelineEnv.reset()
    fitted = rpc.build_pipeline(train, config).fit()
    fitted.save(str(tmp_path / "ckpt"), format="dcp")
    loaded = FittedPipeline.load(str(tmp_path / "ckpt"), device="cpu")
    np.testing.assert_array_equal(fitted.apply(test.data).numpy(),
                                  loaded.apply(test.data).numpy())
    (tmp_path / "ckpt" / "skeleton.pkl").write_bytes(b"not a pickle")
    with pytest.raises(RuntimeError, match="skeleton"):
        FittedPipeline.load(str(tmp_path / "ckpt"), device="cpu")
    with pytest.raises(ValueError, match="format"):
        fitted.save(str(tmp_path / "x"), format="orbax")


def test_launcher_ranks_agree(tmp_path):
    """Two `python -m keystone_tpu_torch --coordinator ... --device cpu`
    ranks of the small RandomPatchCifar print the same scores."""
    port = worker._free_port()
    args = ["RandomPatchCifar", "--device", "cpu", "--num-filters", "16",
            "--block-size", "64", "--synth-train", "600", "--synth-test",
            "200"]
    outs = worker.spawn(
        [["-m", "keystone_tpu_torch", "--coordinator", f"127.0.0.1:{port}",
          "--num-processes", "2", "--process-id", str(r)] + args
         for r in range(2)], str(tmp_path))
    lines = [[ln for ln in out.splitlines() if ln.startswith("train_error=")]
             for out in outs]
    assert len(lines[0]) == 1, outs[0][-2000:]
    scores = [ln[0].split(" train_time")[0] for ln in lines]
    assert scores[0] == scores[1]


def test_launcher_flags_need_a_coordinator():
    """Without ``--coordinator`` the error is JAX's launcher's."""
    from keystone_tpu.__main__ import _pop_multihost_flags as jax_pop

    with pytest.raises(SystemExit) as jax_err:
        jax_pop(["--num-processes", "2", "RandomPatchCifar"])
    with pytest.raises(SystemExit) as err:
        launcher.main(["--num-processes", "2", "RandomPatchCifar"])
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(SystemExit, match="requires a value"):
        launcher.main(["RandomPatchCifar", "--process-id"])
