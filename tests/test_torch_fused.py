"""The one-stream `run_fused` of RandomPatchCifar: the port against the
JAX package's one-program `run_fused` on the CPU, at 16 filters, 64-wide
BCD blocks and 32-row microbatches with a ragged last one.

JAX's filters and whitener (its `learn_filters`, the program its fused
step inlines, at ``PRNGKey(seed)``) are carried across, and the port's
`fused_fit` must give JAX's raw-feature (W, b) within 1e-4 of their
largest magnitude and the same confusion matrices; its scores must equal
the port's own staged pipeline's (scaler, then BCD) within 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.pipelines.random_patch_cifar import (
    RandomPatchCifarConfig as JaxConfig,
    learn_filters as jax_learn_filters,
    run_fused as jax_run_fused,
)
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning import block_ls
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromInt
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc

CFG = dict(num_filters=16, block_size=64, microbatch=32, sample_patches=5000)
N_TRAIN, N_TEST = 300, 100  # 300 = 9·32 + 12: a ragged last microbatch


@pytest.fixture(scope="module")
def fused():
    jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2, confusion=0.6)
    jconfig = JaxConfig(**CFG)
    res = jax_run_fused(jtrain, jtest, jconfig)
    filters, whitener = jax_learn_filters(jtrain.data, jconfig)
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    config = rpc.RandomPatchCifarConfig(**CFG)
    port_filters = convert.to_tensor(filters, "cpu")
    port_whitener = convert.whitener(whitener.whitener, whitener.means, "cpu")
    W, b, conf_train, conf_test, info = rpc.fused_fit(
        train, test, port_filters, port_whitener, config)
    return dict(jax=res, train=train, test=test, config=config,
                filters=port_filters, whitener=port_whitener, W=W, b=b,
                conf_train=conf_train, conf_test=conf_test, info=info)


def test_fused_fit_weights_match_jax(fused):
    """The raw-feature (W, b) folded back from BCD on scaled features:
    within 1e-4 of their largest magnitude of JAX's."""
    jW, jb = np.asarray(fused["jax"]["W"]), np.asarray(fused["jax"]["b"])
    W, b = fused["W"].numpy(), fused["b"].numpy()
    assert W.shape == jW.shape == (2 * 2 * 2 * 16, 10)
    assert int(fused["info"]) == 0
    np.testing.assert_allclose(W, jW, rtol=0,
                               atol=1e-4 * float(np.abs(jW).max()))
    np.testing.assert_allclose(b, jb, rtol=0,
                               atol=1e-4 * float(np.abs(jb).max()))


@pytest.mark.parametrize("which", ["train", "test"])
def test_fused_confusion_matrices_match_jax(fused, which):
    got = fused[f"conf_{which}"].numpy()
    want = fused["jax"][f"{which}_metrics"].confusion
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (N_TRAIN if which == "train" else N_TEST)


def test_fused_scores_match_staged_pipeline(fused):
    """x·W_raw + b_raw on raw features against the staged path's scaler
    and BCD on the same features: the same scores within 1e-4, the same
    argmax."""
    config = fused["config"]
    featurizer = rpc.make_featurizer(fused["filters"], fused["whitener"],
                                     32, 32, 3, config)
    feats = featurizer.apply_batch(fused["train"].data)
    scaler = StandardScaler().fit(feats)
    model = BlockLeastSquaresEstimator(config.block_size, config.bcd_iters,
                                       lam=config.lam).fit(
        scaler.apply_batch(feats),
        ClassLabelIndicatorsFromInt(10).apply_batch(fused["train"].labels))
    test_feats = featurizer.apply_batch(fused["test"].data)
    want = model.apply_batch(scaler.apply_batch(test_feats)).numpy()
    got = (test_feats.array @ fused["W"] + fused["b"]).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_fused_featurize_writes_kernel_rows_in_place(fused):
    """The fused kernel's wrapper writes a microbatch into given rows of
    a larger matrix, as `fused_fit` preallocates it."""
    imgs = fused["train"].data.array[:40] / 255.0
    conv = rpc.Convolver(fused["filters"], 32, 32, 3,
                         whitener=fused["whitener"])
    args = (kernels.hwio_to_cmajor(conv.kernel).contiguous(), conv.colsum,
            conv.bias, 0.25, 0.0, 14, 13, True, 6)
    want = kernels.conv_rectify_pool(imgs, *args).reshape(40, -1)
    out = torch.full((50, want.shape[1]), -1.0)
    got = kernels.conv_rectify_pool(imgs, *args, out=out[5:45])
    assert got.data_ptr() == out[5:45].data_ptr()
    torch.testing.assert_close(out[5:45], want, rtol=0, atol=0)
    assert bool((out[:5] == -1).all()) and bool((out[45:] == -1).all())
    with pytest.raises(ValueError, match="cannot take"):
        kernels.conv_rectify_pool(imgs, *args, out=out[5:44])


def test_run_fused_learns_the_staged_filters(fused, monkeypatch):
    """`run_fused` learns its filters as the staged path does (the same
    draws from ``config.seed``): its model scores as a staged fit on
    those filters does, and its metrics count every image."""
    seen = []
    real = rpc.fused_fit

    def spy(train, test, filters, whitener, config, clock=None):
        seen.append((filters, whitener))
        return real(train, test, filters, whitener, config, clock)

    monkeypatch.setattr(rpc, "fused_fit", spy)
    res = rpc.run_fused(fused["train"], fused["test"], fused["config"])
    staged_filters, staged_whitener = rpc.learn_filters(
        fused["train"].data, fused["config"])
    torch.testing.assert_close(seen[0][0], staged_filters, rtol=0, atol=0)
    torch.testing.assert_close(seen[0][1].whitener, staged_whitener.whitener,
                               rtol=0, atol=0)
    assert res["train_metrics"].total == N_TRAIN
    assert res["test_metrics"].total == N_TEST
    assert res["stage_ms"] == {}  # no events off the card
    assert res["train_error"] < 0.5


def test_run_fused_refuses_an_unfactored_gram(fused, monkeypatch):
    """BCD's positive-definiteness check, left on the device by
    `cholesky_ex`, is read with the confusion matrices and raises."""
    real = block_ls.bcd_fit

    def failing(*args, **kwargs):
        W, b, info = real(*args, **kwargs)
        return W, b, info + 3

    monkeypatch.setattr(rpc, "bcd_fit", failing)
    with pytest.raises(torch.linalg.LinAlgError, match="order 3"):
        rpc.run_fused(fused["train"], fused["test"], fused["config"])


def test_run_fused_cli_on_the_cpu(capsys):
    """`main --fused`: the rate counts train + test images."""
    result = rpc.main(["--fused", "--num-filters", "8", "--block-size", "64",
                       "--synth-train", "96", "--synth-test", "32",
                       "--device", "cpu"])
    assert math.isfinite(result["train_error"])
    assert result["images_per_sec"] == pytest.approx(
        128 / result["train_seconds"])
    assert result["rate_basis"].startswith("train+test")
    assert "train_error=" in capsys.readouterr().out


def test_fused_run_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rpc.run(rpc.RandomPatchCifarConfig(synth_train=8, synth_test=4),
                fused=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rpc.main(["--fused", "--synth-train", "8", "--synth-test", "4"])
