"""RandomPatchCifar end to end: the port against the JAX package at a
small configuration (16 filters, 64-wide BCD blocks, 32-row microbatches
with a ragged last one), on the CPU.

The JAX package fits through `run_staged`, which returns its fitted
parts. Its learned filters and whitener are carried across with
`keystone_tpu_torch.convert`, so the port featurizes with the same
weights; every later stage is fit by the port and held against JAX's.
"""

import math

import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import (
    MulticlassClassifierEvaluator as JaxEvaluator,
)
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.util import MaxClassifier as JaxMax
from keystone_tpu.pipelines.random_patch_cifar import (
    RandomPatchCifarConfig as JaxConfig,
    run_staged,
)
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromInt
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc

CFG = dict(num_filters=16, block_size=64, microbatch=32, sample_patches=5000)
N_TRAIN, N_TEST = 300, 100  # 300 = 9·32 + 12: a ragged last microbatch


@pytest.fixture(scope="module")
def fitted():
    """Both packages' data and JAX's fitted parts, built once."""
    jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2, confusion=0.6)
    config = JaxConfig(**CFG)
    _, _, parts = run_staged(jtrain, config, JaxEvaluator(10))
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    jfeats = parts["featurizer"].apply_batch(jtrain.data).numpy()
    return dict(jtrain=jtrain, jtest=jtest, parts=parts, train=train,
                test=test, jfeats=jfeats, config=rpc.RandomPatchCifarConfig(
                    **CFG))


def _port_featurizer(f):
    parts = f["parts"]
    w = parts["whitener"]
    return rpc.make_featurizer(
        convert.to_tensor(parts["filters"], "cpu"),
        convert.whitener(w.whitener, w.means, "cpu"), 32, 32, 3, f["config"])


def test_synthetic_data_is_bit_identical(fitted):
    """Both packages' generators give the same arrays for one seed."""
    for port, jax_ in ((fitted["train"], fitted["jtrain"]),
                       (fitted["test"], fitted["jtest"])):
        np.testing.assert_array_equal(port.data.numpy(), jax_.data.numpy())
        np.testing.assert_array_equal(port.labels.numpy(),
                                      jax_.labels.numpy())


def test_features_match_jax(fitted):
    """The port's featurizer with JAX's filters and whitener against
    JAX's featurizer: both fp32 convs on the CPU, sums in another order.
    Tolerance 1e-5 of the features' scale."""
    got = _port_featurizer(fitted).apply_batch(fitted["train"].data).numpy()
    want = fitted["jfeats"]
    assert got.shape == want.shape == (N_TRAIN, 2 * 2 * 2 * 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_scaler_and_solver_match_jax(fitted):
    """Scaler moments and BCD's W, b fit by the port on its own features
    against JAX's fitted parts. The features already differ by fp32
    summation order; the solve (λ=10, two 64-wide blocks) passes that
    through: 5e-5 relative on mean and std, 1e-4 of the largest weight
    on W and b."""
    parts = fitted["parts"]
    feats = _port_featurizer(fitted).apply_batch(fitted["train"].data)
    scaler = StandardScaler().fit(feats)
    np.testing.assert_allclose(scaler.mean.numpy(),
                               np.asarray(parts["scaler"].mean), rtol=5e-5,
                               atol=1e-6)
    np.testing.assert_allclose(scaler.std.numpy(),
                               np.asarray(parts["scaler"].std), rtol=5e-5,
                               atol=1e-6)
    labels = ClassLabelIndicatorsFromInt(10).apply_batch(
        fitted["train"].labels)
    model = BlockLeastSquaresEstimator(64, 1, lam=10.0).fit(
        scaler.apply_batch(feats), labels)
    jW, jb = np.asarray(parts["model"].W), np.asarray(parts["model"].b)
    assert tuple(model.W.shape) == jW.shape
    np.testing.assert_allclose(model.W.numpy(), jW, rtol=0,
                               atol=1e-4 * float(np.abs(jW).max()))
    np.testing.assert_allclose(model.b.numpy(), jb, rtol=0,
                               atol=1e-4 * float(np.abs(jb).max()))


def test_carried_predictor_agrees_with_jax(fitted):
    """The port's predictor built by `convert.fitted_predictor` from all
    of JAX's fitted parameters predicts the test set as JAX does: at
    least 99% of the labels agree (a near-tie may flip)."""
    parts = fitted["parts"]
    w = parts["whitener"]
    predictor = convert.fitted_predictor(
        parts["filters"], w.whitener, w.means, parts["scaler"].mean,
        parts["scaler"].std, parts["model"].W, parts["model"].b,
        (32, 32, 3), fitted["config"], device="cpu")
    got = predictor(fitted["test"].data).get().numpy()
    jtest = fitted["jtest"].data
    want = JaxMax().apply_batch(parts["model"].apply_batch(
        parts["scaler"].apply_batch(parts["featurizer"].apply_batch(jtest)))
    ).numpy()
    assert got.shape == want.shape == (N_TEST,)
    assert float(np.mean(got == want)) >= 0.99


def test_pipeline_featurizes_train_once(fitted, monkeypatch):
    """The Cacher keeps the scaler fit, the solver fit and the train
    predict from featurizing the training set more than once."""
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    rows = []
    real = FusedBatchTransformer.apply_batch

    def counting(self, data):
        # the featurizer's microbatched chain, or the megafused apply path
        # that holds it, not the fused apply head
        if any(isinstance(s, Convolver) or any(
                isinstance(t, Convolver) for t in getattr(s, "stages", ()))
               for s in self.stages):
            rows.append(data.count)
        return real(self, data)

    monkeypatch.setattr(FusedBatchTransformer, "apply_batch", counting)
    predictor = rpc.build_pipeline(fitted["train"], fitted["config"])
    train_preds = predictor(fitted["train"].data).get()
    predictor(fitted["test"].data).get()
    assert rows == [N_TRAIN, N_TEST]
    assert train_preds.count == N_TRAIN


def test_run_staged_times_every_stage(fitted):
    """The staged run covers the reference app's five phases and scores
    the training set."""
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator

    stages, metrics = rpc.run_staged(fitted["train"], fitted["config"],
                                     MulticlassClassifierEvaluator(10))
    assert list(stages) == ["filter_learning", "featurize", "scaler",
                            "bcd_solve", "predict_eval"]
    assert all(s >= 0.0 for s in stages.values())
    assert metrics.total == N_TRAIN


def test_run_end_to_end_on_cpu():
    """The whole slice through `run`: a finite error."""
    result = rpc.run(rpc.RandomPatchCifarConfig(
        synth_train=N_TRAIN, synth_test=N_TEST, **CFG), device="cpu")
    assert math.isfinite(result["train_error"])
    assert math.isfinite(result["test_error"])
    assert 0.0 <= result["test_accuracy"] <= 1.0
    assert isinstance(result["predictor"](torch.zeros(32, 32, 3)).get(),
                      torch.Tensor)
