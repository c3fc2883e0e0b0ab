"""LinearPixels and RandomPatchCifarKernel end to end: the port against
the JAX package on the CPU, at 300 training and 100 test images.

The JAX side runs each pipeline's stages as
`keystone_tpu/pipelines/cifar_variants.py` chains them. Its fitted
parameters are carried across with `keystone_tpu_torch.convert`, and the
port's own fits, from the same data and (for the kernel pipeline) JAX's
learned filters, are held against them: the predicted labels must be the
same and the scores within 1e-4 of their largest magnitude (1e-3 for
LinearPixels' own fit, whose reason its test gives).
"""

import numpy as np
import pytest

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.images.core import (
    Convolver as JaxConvolver,
    GrayScaler as JaxGrayScaler,
    ImageVectorizer as JaxImageVectorizer,
    PixelScaler as JaxPixelScaler,
    Pooler as JaxPooler,
    SymmetricRectifier as JaxSymmetricRectifier,
)
from keystone_tpu.nodes.learning import (
    KernelRidgeRegression as JaxKernelRidgeRegression,
    LinearMapEstimator as JaxLinearMapEstimator,
)
from keystone_tpu.nodes.stats import StandardScaler as JaxStandardScaler
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util.fusion import (
    FusedBatchTransformer as JaxFusedBatchTransformer,
)
from keystone_tpu.pipelines.cifar_variants import (
    RandomPatchCifarKernelConfig as JaxKernelConfig,
)
from keystone_tpu.pipelines.random_patch_cifar import (
    learn_filters as jax_learn_filters,
)
from keystone_tpu_torch import convert
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.learning import KernelRidgeRegression
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromInt
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.pipelines import cifar_variants as cv
from keystone_tpu_torch.workflow.pipeline import Pipeline

N_TRAIN, N_TEST = 300, 100
KERNEL_CFG = dict(num_filters=16, microbatch=32, sample_patches=5000,
                  kernel_block=64, gamma=2e-3, lam=10.0, kernel_epochs=1)


@pytest.fixture(scope="module")
def data():
    jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2, confusion=0.6)
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    return jtrain, jtest, train, test


def _scorer(predictor):
    """``predictor`` with its sink moved off the final MaxClassifier."""
    g = predictor.graph
    argmax = g.get_sink_dependency(predictor.sink)
    g = g.set_sink_dependency(predictor.sink, g.get_dependencies(argmax)[0])
    return Pipeline(g, predictor.source, predictor.sink)


def _scores(predictor, x):
    """The predictor's scores: every node but the final MaxClassifier."""
    return _scorer(predictor)(x).get().numpy()


def _assert_same_predictions(got_scores, want_scores, rel=1e-4):
    assert got_scores.shape == want_scores.shape
    np.testing.assert_array_equal(got_scores.argmax(1),
                                  want_scores.argmax(1))
    np.testing.assert_allclose(
        got_scores, want_scores, rtol=0,
        atol=rel * float(np.abs(want_scores).max()))


@pytest.fixture(scope="module")
def linear_pixels(data):
    jtrain, jtest, _, _ = data
    featurizer = JaxFusedBatchTransformer(
        [JaxPixelScaler(), JaxGrayScaler(), JaxImageVectorizer()],
        microbatch=4096)
    labels = JaxIndicators(10).apply_batch(jtrain.labels)
    model = JaxLinearMapEstimator(1.0).fit(
        featurizer.apply_batch(jtrain.data), labels)
    scores = model.apply_batch(featurizer.apply_batch(jtest.data)).numpy()
    return model, np.asarray(scores)


def test_linear_pixels_carried_fit_matches_jax(linear_pixels, data):
    """JAX's fitted W, b in the port's LinearPixels predictor."""
    model, want = linear_pixels
    predictor = convert.fitted_linear_pixels(np.asarray(model.W),
                                             np.asarray(model.b), "cpu")
    _assert_same_predictions(_scores(predictor, data[3].data), want)


def test_linear_pixels_port_fit_matches_jax(linear_pixels, data):
    """`build_linear_pixels` fits the port's own normal equations on the
    same pixels (the path has no randomness). Scores within 1e-3 of their
    largest magnitude: the intercept's Gram correction XᵀX − n·x̄x̄ᵀ
    cancels about one and a half of fp32's digits on pixels near 0.5,
    and the system's condition number (about 300 here) scales that, so
    each package's fp32 fit lies about 4e-4 from the float64 solution."""
    _, want = linear_pixels
    _, _, train, test = data
    predictor = cv.build_linear_pixels(train, cv.LinearPixelsConfig())
    _assert_same_predictions(_scores(predictor, test.data), want, rel=1e-3)
    preds = predictor(test.data).get().numpy()
    np.testing.assert_array_equal(preds, want.argmax(1))


@pytest.fixture(scope="module")
def kernel_cifar(data):
    jtrain, jtest, _, _ = data
    config = JaxKernelConfig(**KERNEL_CFG)
    filters, whitener = jax_learn_filters(jtrain.data, config)
    featurizer = JaxFusedBatchTransformer(
        [JaxPixelScaler(),
         JaxConvolver(filters, 32, 32, 3, whitener=whitener),
         JaxSymmetricRectifier(alpha=config.alpha),
         JaxPooler(config.pool_stride, config.pool_size, pool_fn="sum"),
         JaxImageVectorizer()], microbatch=config.microbatch)
    feats = featurizer.apply_batch(jtrain.data)
    scaler = JaxStandardScaler().fit(feats)
    labels = JaxIndicators(10).apply_batch(jtrain.labels)
    model = JaxKernelRidgeRegression(
        config.gamma, config.lam, config.kernel_block,
        config.kernel_epochs).fit(scaler.apply_batch(feats), labels)
    scores = model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(jtest.data))).numpy()
    return dict(filters=np.asarray(filters), whitener=whitener, scaler=scaler,
                model=model, scores=np.asarray(scores),
                config=cv.RandomPatchCifarKernelConfig(**KERNEL_CFG))


def test_kernel_cifar_carried_fit_matches_jax(kernel_cifar, data):
    """JAX's filters, whitener, scaler and kernel model (anchors and
    alpha, its padded rows dropped) in the port's predictor."""
    k = kernel_cifar
    model = k["model"]
    predictor = convert.fitted_kernel_predictor(
        k["filters"], k["whitener"].whitener, k["whitener"].means,
        k["scaler"].mean, k["scaler"].std,
        np.asarray(model.train_X)[:N_TRAIN], np.asarray(model.alpha)[:N_TRAIN],
        model.gamma, model.block_size, (32, 32, 3), k["config"],
        device="cpu")
    _assert_same_predictions(_scores(predictor, data[3].data), k["scores"])


def test_kernel_cifar_port_fit_matches_jax(kernel_cifar, data):
    """With JAX's filters carried across, the port featurizes, fits its
    scaler and its kernel ridge regression (five 64-row blocks, the last
    repeating 20 ids) and predicts as JAX does."""
    k = kernel_cifar
    _, _, train, test = data
    config = k["config"]
    featurizer = cv.make_featurizer(
        convert.to_tensor(k["filters"], "cpu"),
        convert.whitener(k["whitener"].whitener, k["whitener"].means, "cpu"),
        32, 32, 3, config)
    feats = featurizer.apply_batch(train.data)
    scaler = StandardScaler().fit(feats)
    labels = ClassLabelIndicatorsFromInt(10).apply_batch(train.labels)
    model = KernelRidgeRegression(config.gamma, config.lam,
                                  config.kernel_block,
                                  config.kernel_epochs).fit(
        scaler.apply_batch(feats), labels)
    got = model.apply_batch(scaler.apply_batch(
        featurizer.apply_batch(test.data))).numpy()
    _assert_same_predictions(got, k["scores"])


def test_build_random_patch_cifar_kernel_learns(data, monkeypatch):
    """The port's own pipeline, its filters drawn by its own generator:
    the kernel model fits in five block steps (300 rows in 64-row
    blocks) and scores far above chance (0.1) on both sets."""
    from keystone_tpu_torch.nodes.learning import kernels as port_kernels

    _, _, train, test = data
    steps = []
    real_step = port_kernels.krr_step

    def counting(*args):
        steps.append(args[-1].shape[0])
        return real_step(*args)

    monkeypatch.setattr(port_kernels, "krr_step", counting)
    predictor = cv.build_random_patch_cifar_kernel(
        train, cv.RandomPatchCifarKernelConfig(**KERNEL_CFG))
    evaluator = MulticlassClassifierEvaluator(10)
    train_metrics = evaluator(predictor(train.data), train.labels)
    test_metrics = evaluator(predictor(test.data), test.labels)
    assert steps == [64] * 5
    assert train_metrics.accuracy > 0.6
    assert test_metrics.accuracy > 0.3


@pytest.mark.parametrize("pipeline", ["linear-pixels", "kernel"])
def test_cli_runs_on_the_cpu(pipeline, capsys):
    extra = (["--num-filters", "8", "--kernel-block", "64"]
             if pipeline == "kernel" else [])
    result = cv.main([pipeline, "--synth-train", "96", "--synth-test", "32",
                      "--device", "cpu"] + extra)
    assert 0.0 <= result["test_accuracy"] <= 1.0
    assert "train_error=" in capsys.readouterr().out


def test_cpu_run_launches_no_kernel(data):
    """On the CPU every wrapper takes its plain version: no launch is
    counted."""
    kernels.reset_launches()
    _, _, train, test = data
    predictor = cv.build_linear_pixels(train, cv.LinearPixelsConfig())
    predictor(test.data).get()
    from keystone_tpu_torch.ops import chain_kernels

    assert chain_kernels.elementwise_chain.launches == 0
    assert kernels.rbf_block.launches == 0


def test_entry_points_raise_without_a_card():
    """Called without ``device="cpu"``, the new entry points ask for the
    card; with no card they raise instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.run_linear_pixels(cv.LinearPixelsConfig(synth_train=8,
                                                   synth_test=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.run_random_patch_cifar_kernel(cv.RandomPatchCifarKernelConfig(
            synth_train=8, synth_test=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.main(["linear-pixels", "--synth-train", "8", "--synth-test", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.fitted_linear_pixels(np.zeros((1024, 10), np.float32),
                                     np.zeros(10, np.float32))
