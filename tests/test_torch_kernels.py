"""The port's featurizer kernels against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in `keystone_tpu_torch.ops`. On the CPU the port's
wrappers run their plain PyTorch versions; the JAX Pallas kernels run in
interpret mode, as `tests/test_pallas_ops.py` runs them. The CUDA
kernels themselves are held against the plain versions on the card by
`tests/test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import (
    conv_rectify_pool_pallas,
    conv_rectify_pool_reference as jax_conv_rectify_pool_reference,
    rectify_pool_pallas,
    rectify_pool_reference as jax_rectify_pool_reference,
)
from keystone_tpu.ops.chain_kernels import (
    rectify_pool_vectorize_pallas,
    rectify_pool_vectorize_reference as jax_rectify_pool_vectorize_reference,
)
from keystone_tpu_torch.ops import kernels

# geometries and ragged counts of tests/test_pallas_ops.py:117-160
CONV_GEOMETRIES = [
    (5, 32, 32, 3, 6, 32, 14, 13, True),   # CIFAR north-star geometry
    (3, 16, 16, 1, 5, 16, 6, 6, False),    # gray, no normalization
    (2, 20, 14, 2, 3, 8, 5, 4, True),      # rectangular
    (3, 16, 16, 1, 2, 8, 5, 5, False),     # npos=225, cells=9
    (5, 12, 12, 1, 3, 8, 10, 10, True),    # cells=1
    (3, 12, 10, 2, 3, 8, 8, 2, False),     # cells=2 (1x2)
]

# geometries of tests/test_pallas_ops.py:25-40
RECTIFY_GEOMETRIES = [
    (3, 27, 27, 16, 14, 13, 0.25, 0.0),  # CIFAR north-star geometry
    (5, 12, 12, 8, 4, 4, 0.0, 0.0),      # non-overlapping windows
    (2, 10, 14, 4, 5, 3, 0.1, 0.05),     # rectangular, overlap, floor
]


def _conv_inputs(n, h, w, c, patch, k, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random(size=(n, h, w, c)).astype(np.float32)
    kern = rng.normal(size=(patch, patch, c, k)).astype(np.float32)
    colsum = rng.normal(size=(k,)).astype(np.float32)
    bias = rng.normal(size=(k,)).astype(np.float32)
    return x, kern, colsum, bias


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         CONV_GEOMETRIES)
def test_conv_rectify_pool_reference_matches_jax_reference(
        n, h, w, c, patch, k, pool, stride, normalize):
    """Both plain versions in float32. Tolerance 1e-5 of the output's
    scale: only the order of the fp32 sums differs."""
    x, kern, colsum, bias = _conv_inputs(n, h, w, c, patch, k)
    want = np.asarray(jax_conv_rectify_pool_reference(
        jnp.asarray(x), jnp.asarray(kern), jnp.asarray(colsum),
        jnp.asarray(bias), 0.25, 0.0, pool, stride, normalize))
    got = kernels.conv_rectify_pool_reference(
        _t(x), _t(kern), _t(colsum), _t(bias), 0.25, 0.0, pool, stride,
        normalize).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         CONV_GEOMETRIES)
def test_conv_rectify_pool_matches_jax_pallas_kernel(
        n, h, w, c, patch, k, pool, stride, normalize):
    """The port's wrapper on CPU tensors (its fp32 plain version) against
    the JAX Pallas kernel in interpret mode, which feeds bf16 operands.
    Tolerance 2e-2 of the output's scale, as tests/test_pallas_ops.py
    holds the Pallas kernel to its fp32 reference: bf16 rounding of the
    operands, a few parts in 1e3 per product."""
    x, kern, colsum, bias = _conv_inputs(n, h, w, c, patch, k)
    g_cmajor = kern.transpose(2, 0, 1, 3).reshape(-1, k)
    want = np.asarray(conv_rectify_pool_pallas(
        jnp.asarray(x), jnp.asarray(g_cmajor), jnp.asarray(colsum),
        jnp.asarray(bias), 0.25, 0.0, pool, stride, normalize, patch,
        interpret=True))
    got = kernels.conv_rectify_pool(
        _t(x), _t(g_cmajor), _t(colsum), _t(bias), 0.25, 0.0, pool, stride,
        normalize, patch).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=0)


def test_conv_rectify_pool_learned_filters_within_bf16_class():
    """With learned, whitened filters the mean correction cancels two
    large terms, so bf16 operands cost more than on random inputs. The
    JAX Pallas kernel (interpret mode) against the port's fp32 plain
    version on such filters stays within 2e-2 of the output's scale,
    the limit tests/test_pallas_ops.py holds it to and the one the port's
    CUDA kernel is held to on the card."""
    from keystone_tpu.loaders.cifar_loader import synthetic_cifar
    from keystone_tpu.nodes.images.core import Convolver
    from keystone_tpu.pipelines.random_patch_cifar import (
        RandomPatchCifarConfig,
        learn_filters,
    )

    train, _ = synthetic_cifar(200, 8, noise=1.2, confusion=0.6)
    filters, whitener = learn_filters(
        train.data, RandomPatchCifarConfig(num_filters=32,
                                           sample_patches=2000))
    conv = Convolver(filters, 32, 32, 3, whitener=whitener)
    x = train.data.numpy()[:16] / 255.0
    kern, colsum, bias = (np.asarray(a) for a in
                          (conv.kernel, conv.colsum, conv.bias))
    g_cmajor = kern.transpose(2, 0, 1, 3).reshape(-1, kern.shape[3])
    want = kernels.conv_rectify_pool(
        _t(x), _t(g_cmajor), _t(colsum), _t(bias), 0.25, 0.0, 14, 13, True,
        6).numpy()
    got = np.asarray(conv_rectify_pool_pallas(
        jnp.asarray(x), jnp.asarray(g_cmajor), jnp.asarray(colsum),
        jnp.asarray(bias), 0.25, 0.0, 14, 13, True, 6, interpret=True))
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2e-2 * scale


def test_hwio_cmajor_round_trip():
    """The channel-major layout matches the JAX package's
    `hwio_to_cmajor` exactly (a permutation)."""
    from keystone_tpu.ops.pallas_kernels import hwio_to_cmajor

    kern = np.random.default_rng(0).normal(size=(3, 3, 2, 5)).astype(
        np.float32)
    cm = kernels.hwio_to_cmajor(_t(kern))
    np.testing.assert_array_equal(cm.numpy(),
                                  np.asarray(hwio_to_cmajor(jnp.asarray(kern))))
    np.testing.assert_array_equal(kernels.cmajor_to_hwio(cm, 3).numpy(), kern)


@pytest.mark.parametrize("n,h,w,k,pool,stride,alpha,max_val",
                         RECTIFY_GEOMETRIES)
def test_rectify_pool_matches_jax_pallas_kernel(n, h, w, k, pool, stride,
                                                alpha, max_val):
    """The port's wrapper on CPU tensors against the JAX Pallas kernel
    (interpret mode) and the JAX reference. Both sum fp32 values in
    another order: tolerance 1e-5 of the output's scale."""
    x = np.random.default_rng(0).normal(size=(n, h, w, k)).astype(np.float32)
    got = kernels.rectify_pool(_t(x), alpha, max_val, pool, stride).numpy()
    pallas = np.asarray(rectify_pool_pallas(
        jnp.asarray(x), alpha, max_val, pool, stride, block_n=2,
        interpret=True))
    ref = np.asarray(jax_rectify_pool_reference(
        jnp.asarray(x), alpha, max_val, pool, stride))
    assert got.shape == pallas.shape == ref.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, pallas, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("n,h,w,k,pool,stride,alpha,max_val",
                         RECTIFY_GEOMETRIES)
def test_rectify_pool_vectorize_matches_jax(n, h, w, k, pool, stride, alpha,
                                            max_val):
    """K3 is K2 and a flatten: the port's vectorized view against the JAX
    chain kernel (interpret mode) and its reference, same tolerance."""
    x = np.random.default_rng(5).normal(size=(n, h, w, k)).astype(np.float32)
    got = kernels.rectify_pool_vectorize(_t(x), alpha, max_val, pool,
                                         stride).numpy()
    plain = kernels.rectify_pool_vectorize_reference(
        _t(x), alpha, max_val, pool, stride).numpy()
    pallas = np.asarray(rectify_pool_vectorize_pallas(
        jnp.asarray(x), alpha, max_val, pool, stride, block_n=2,
        interpret=True))
    ref = np.asarray(jax_rectify_pool_vectorize_reference(
        jnp.asarray(x), alpha, max_val, pool, stride))
    assert got.shape == pallas.shape == ref.shape == plain.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, pallas, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)


def test_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    """A tensor that is neither on the CPU nor on a card is not sent to
    the plain version: a meta tensor (the static analyzer's) gets an empty
    meta result of the output's shape from the meta branch and launches
    nothing; CPU calls launch no kernel."""
    kernels.reset_launches()
    x = torch.empty((1, 27, 27, 4), device="meta")
    y = kernels.rectify_pool(x, 0.25, 0.0, 14, 13)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 2, 2, 8)
    imgs = torch.empty((1, 32, 32, 3), device="meta")
    g = torch.empty((108, 4), device="meta")
    cs = torch.empty((4,), device="meta")
    y = kernels.conv_rectify_pool(imgs, g, cs, cs, 0.25, 0.0, 14, 13, True, 6)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 2, 2, 8)
    kernels.rectify_pool(torch.zeros((1, 27, 27, 4)), 0.25, 0.0, 14, 13)
    assert kernels.rectify_pool.launches == 0
    assert kernels.conv_rectify_pool.launches == 0
