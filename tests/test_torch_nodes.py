"""The port's RandomPatchCifar nodes against the JAX package's.

Inputs are made from a seed with numpy and handed to both packages; the
port runs on the CPU (``device="cpu"``). Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu_torch.data.dataset import Dataset

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def test_convolver_fold_matches_jax():
    """Folded kernel, colsum and bias from the same filters and
    whitener. Both fold in true fp32 (JAX: Precision.HIGHEST), so only
    the order of the fp32 sums differs: 1e-5 relative."""
    from keystone_tpu.nodes.images.core import Convolver as JaxConvolver
    from keystone_tpu.nodes.learning.zca import ZCAWhitener as JaxZCA
    from keystone_tpu_torch.nodes.images.core import Convolver
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener

    rng = np.random.default_rng(0)
    k, p, c = 12, 6, 3
    d = p * p * c
    filters = rng.normal(size=(k, d)).astype(np.float32)
    W = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    mu = rng.normal(size=(d,)).astype(np.float32)
    want = JaxConvolver(filters, 32, 32, c, whitener=JaxZCA(W, mu))
    got = Convolver(filters, 32, 32, c, whitener=ZCAWhitener(W, mu,
                                                             device=CPU),
                    device=CPU)
    assert tuple(got.kernel.shape) == tuple(want.kernel.shape) == (p, p, c, k)
    for name in ("kernel", "colsum", "bias"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,h,w,c,patch,stride", [
    (3, 32, 32, 3, 6, 1),
    (2, 12, 10, 2, 3, 2),
])
def test_extract_patches_device_matches_jax(n, h, w, c, patch, stride):
    """A gather of pixel values: exactly equal."""
    from keystone_tpu.utils.images import extract_patches_device as jax_fn
    from keystone_tpu_torch.utils.images import extract_patches_device

    x = np.random.default_rng(1).random(size=(n, h, w, c)).astype(np.float32)
    want = np.asarray(jax_fn(jnp.asarray(x), patch, stride))
    got = extract_patches_device(_t(x), patch, stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_standard_scaler_matches_jax():
    """One-pass fp32 moments in both packages; sums in another order:
    1e-5 relative on mean, std and the scaled rows."""
    from keystone_tpu.nodes.stats import StandardScaler as JaxScaler
    from keystone_tpu_torch.nodes.stats import StandardScaler

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(101, 17)) * 3 + 5).astype(np.float32)
    x[:, 3] = 1.5  # a constant feature: std 0 → 1
    jmodel = JaxScaler().fit(JaxDataset(x))
    model = StandardScaler().fit(Dataset(x, device=CPU))
    np.testing.assert_allclose(model.mean.numpy(), np.asarray(jmodel.mean),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.std.numpy(), np.asarray(jmodel.std),
                               rtol=1e-5, atol=1e-5)
    assert float(model.std[3]) == 1.0
    np.testing.assert_allclose(
        model.apply_batch(Dataset(x, device=CPU)).numpy(),
        jmodel.apply_batch(JaxDataset(x)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,block_size,num_iter", [
    (40, 16, 3),   # three blocks, the last one zero-padded
    (40, 64, 1),   # bs > d: one block of width d
])
def test_block_least_squares_matches_jax(d, block_size, num_iter):
    """BCD W and b against JAX's BlockLeastSquaresEstimator. Both solve
    in fp32 (Cholesky in the port, `solve(assume_a="pos")` in JAX) with
    λ=2 keeping the blocks well conditioned: 1e-4 relative."""
    from keystone_tpu.nodes.learning import (
        BlockLeastSquaresEstimator as JaxBLS,
    )
    from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator

    rng = np.random.default_rng(3)
    n, k = 200, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d, k)) + rng.normal(size=(n, k)) + 0.5
         ).astype(np.float32)
    jm = JaxBLS(block_size, num_iter, lam=2.0).fit(JaxDataset(x),
                                                   JaxDataset(y))
    m = BlockLeastSquaresEstimator(block_size, num_iter, lam=2.0).fit(
        Dataset(x, device=CPU), Dataset(y, device=CPU))
    assert tuple(m.W.shape) == tuple(np.asarray(jm.W).shape)
    np.testing.assert_allclose(m.W.numpy(), np.asarray(jm.W), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(m.b.numpy(), np.asarray(jm.b), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        m.apply_batch(Dataset(x, device=CPU)).numpy(),
        jm.apply_batch(JaxDataset(x)).numpy(), rtol=1e-4, atol=1e-4)


def test_label_nodes_and_confusion_match_jax():
    """Indicators, argmax and the confusion matrix are exact."""
    from keystone_tpu.evaluation import (
        MulticlassClassifierEvaluator as JaxEvaluator,
    )
    from keystone_tpu.nodes.util import (
        ClassLabelIndicatorsFromInt as JaxIndicators,
        MaxClassifier as JaxMax,
    )
    from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromInt,
        MaxClassifier,
    )

    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, size=37).astype(np.int32)
    scores = rng.normal(size=(37, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ClassLabelIndicatorsFromInt(5).apply_batch(
            Dataset(labels, device=CPU)).numpy(),
        JaxIndicators(5).apply_batch(JaxDataset(labels)).numpy())
    preds = MaxClassifier().apply_batch(Dataset(scores, device=CPU))
    np.testing.assert_array_equal(
        preds.numpy(), JaxMax().apply_batch(JaxDataset(scores)).numpy())
    got = MulticlassClassifierEvaluator(5).evaluate(
        preds, Dataset(labels, device=CPU))
    want = JaxEvaluator(5).evaluate(
        JaxDataset(preds.numpy().astype(np.int32)), JaxDataset(labels))
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.accuracy == want.accuracy
    assert got.summary() == want.summary()


def test_filter_learning_from_jax_draws_matches_jax():
    """The port's filter learning, fed the exact indices `jax.random`
    draws for the same key, against JAX's `learn_filters`. fp32 `eigh`
    in both; its sign conventions cancel in V·diag·Vᵀ. Tolerance 2e-5
    absolute on the whitener (entries up to about 3), the means and the
    unit-norm filters: the two fp32 eigensolvers agree to a few parts in
    1e6 on this spectrum, which ε=0.1 floors."""
    from keystone_tpu.loaders.cifar_loader import (
        synthetic_cifar as jax_synthetic,
    )
    from keystone_tpu.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig as JaxConfig,
        learn_filters as jax_learn_filters,
    )
    from keystone_tpu_torch.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        filter_sample_sizes,
        learn_filters_from_indices,
    )

    cfg = dict(num_filters=16, sample_patches=2000, seed=3)
    train, _ = jax_synthetic(200, 8, noise=1.2, confusion=0.6)
    jfilters, jwhitener = jax_learn_filters(train.data, JaxConfig(**cfg))

    n = train.data.count
    images = train.data.numpy()
    config = RandomPatchCifarConfig(**cfg)
    n_sample, total, m = filter_sample_sizes(n, 32, 32, config)
    k_img, k_patch, k_filt = jax.random.split(jax.random.PRNGKey(3), 3)
    _, img_idx = jax.lax.top_k(jax.random.uniform(k_img, (n,)), n_sample)
    patch_idx = jax.random.randint(k_patch, (m,), 0, total)
    _, filt_idx = jax.lax.top_k(jax.random.uniform(k_filt, (m,)), 16)

    filters, whitener = learn_filters_from_indices(
        _t(images), *(torch.from_numpy(np.asarray(i, np.int64))
                      for i in (img_idx, patch_idx, filt_idx)),
        config.patch_size, config.patch_steps)
    np.testing.assert_allclose(whitener.means.numpy(),
                               np.asarray(jwhitener.means), atol=2e-5)
    np.testing.assert_allclose(whitener.whitener.numpy(),
                               np.asarray(jwhitener.whitener), atol=2e-5)
    np.testing.assert_allclose(filters.numpy(), np.asarray(jfilters),
                               atol=2e-5)
