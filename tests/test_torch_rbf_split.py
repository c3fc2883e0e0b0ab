"""The numerics of the RBF kernel's 3xTF32 split, on the CPU.

The port's RBF kernel (``keystone_tpu_torch/csrc/rbf_block.cu``) splits
each fp32 value x into hi, x truncated to TF32, and lo = x − hi, and sums
hi·lo + lo·hi + hi·hi on the tensor cores. Here its plain emulation
(``ops/kernels.py::tf32_split``, ``rbf_block_3xtf32_emulated``) is held
against the JAX package's RBF block: its XLA reference at
``Precision.HIGHEST`` and its Pallas kernel in interpret mode, as
``tests/test_pallas_ops.py`` runs it. The inputs are made with numpy
from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.ops import rbf_block_pallas
from keystone_tpu.ops import rbf_block_reference as jax_rbf_block_reference
from keystone_tpu_torch.ops import kernels

# the RBF kernel's tolerance on the card (chip_smoke.py's K5_TOL): max
# abs error on outputs in (0, 1], the diagonal included, where
# x2 + y2 − 2xy cancels
K5_TOL = 5e-5
# a fit block of RandomPatchCifarKernel: 2048 standardized features,
# gamma 2e-3; rows of X against rows of X, so every column has a diagonal
FIT_D, FIT_GAMMA = 2048, 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(kind, rng):
    if kind == "normal":
        return rng.normal(size=(64, 33))
    if kind == "wide_exponents":
        mag = 10.0 ** rng.uniform(-30, 30, size=(64, 33))
        return mag * rng.choice([-1.0, 1.0], size=(64, 33))
    if kind == "tf32_exact":  # values that are their own hi: lo is 0
        return rng.integers(-1024, 1024, size=(64, 33)) / 64.0
    # zero, powers of two, the extremes of fp32, a subnormal, and values
    # with only low mantissa bits set below a power of two
    f32 = np.finfo(np.float32)
    return np.array([[0.0, 1.0, -1.0, 1.5, 2.0 ** -20, f32.max, -f32.max,
                      f32.tiny, f32.tiny / 8, 1.0 + 2.0 ** -23,
                      -(1.0 + 2.0 ** -13), 3.0 - 2.0 ** -22]])


@pytest.mark.parametrize("kind", ["normal", "wide_exponents", "tf32_exact",
                                  "special"])
def test_tf32_split_is_exact(kind):
    """hi + lo == x, lo == x − hi exactly (checked in float64), and hi
    keeps no bit below TF32's 10-bit mantissa."""
    x = _values(kind, np.random.default_rng(0)).astype(np.float32)
    hi, lo = kernels.tf32_split(_t(x))
    hi, lo = hi.numpy(), lo.numpy()
    assert np.array_equal(hi + lo, x)
    assert np.array_equal(x.astype(np.float64) - hi.astype(np.float64),
                          lo.astype(np.float64))
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.array_equal(np.sign(hi[hi != 0]), np.sign(x[hi != 0]))
    if kind == "tf32_exact":
        assert not lo.any()


def _fit_block(seed, m=400, n=256):
    """X (m, 2048) standardized, Yb = n of X's rows, and their indices."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, FIT_D)).astype(np.float32)
    ids = rng.permutation(m)[:n]
    return X, np.ascontiguousarray(X[ids]), ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_matches_jax_reference_at_fit_width(seed):
    """Three TF32 products hold K5_TOL against JAX's HIGHEST-precision
    reference at a fit block's width, on the diagonal too."""
    X, Yb, ids = _fit_block(seed)
    got = kernels.rbf_block_3xtf32_emulated(_t(X), _t(Yb), FIT_GAMMA).numpy()
    want = np.asarray(jax_rbf_block_reference(jnp.asarray(X), jnp.asarray(Yb),
                                              FIT_GAMMA))
    assert got.shape == want.shape == (X.shape[0], Yb.shape[0])
    assert np.abs(got - want).max() <= K5_TOL
    assert got[ids, np.arange(len(ids))].min() >= 1.0 - K5_TOL


@pytest.mark.parametrize("m,n,d", [
    (70, 33, 50),      # ragged on every axis of the JAX tiling
    (130, 200, 300),   # two row tiles, two column tiles, ragged depth
    (9, 200, 513),     # a depth loop with a ragged last step
])
def test_3xtf32_matches_jax_pallas_interpret(m, n, d):
    """The emulation against JAX's Pallas kernel in interpret mode (bm
    64, bn 128, bk 256) at the ragged shapes of
    test_torch_kernel_methods.py, on random rows and on X against its
    own first rows."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    gamma = 0.07 * 50.0 / d
    for Yb in (Y, np.ascontiguousarray(X[:min(m, n)])):
        got = kernels.rbf_block_3xtf32_emulated(_t(X), _t(Yb), gamma).numpy()
        want = np.asarray(rbf_block_pallas(jnp.asarray(X), jnp.asarray(Yb),
                                           gamma, bm=64, bn=128, bk=256,
                                           interpret=True))
        assert got.shape == want.shape == (m, Yb.shape[0])
        assert np.abs(got - want).max() <= K5_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_tf32_product_misses_the_diagonal(seed):
    """One TF32 product (hi·hi alone) drops about 2·x·lo per term: at a
    fit block's width the diagonal falls below 1 − K5_TOL, which is why
    the kernel takes three."""
    X, Yb, ids = _fit_block(seed)
    one = kernels.rbf_block_3xtf32_emulated(_t(X), _t(Yb), FIT_GAMMA,
                                            products=1).numpy()
    want = np.asarray(jax_rbf_block_reference(jnp.asarray(X), jnp.asarray(Yb),
                                              FIT_GAMMA))
    diag = (ids, np.arange(len(ids)))
    assert np.abs(one[diag] - want[diag]).max() > K5_TOL
    assert one[diag].min() < 1.0 - K5_TOL


@pytest.mark.parametrize("m,d", [(70, 50), (9, 513), (33, 2048)])
def test_rbf_split_cpu_matches_jax_norms(m, d):
    """The prepass's plain version: hi + lo is X, and the squared norms
    agree with the ones JAX's wrapper takes outside its pallas_call."""
    X = np.random.default_rng(4).normal(size=(m, d)).astype(np.float32)
    hi, lo, x2 = kernels.rbf_split(_t(X))
    assert np.array_equal((hi + lo).numpy(), X)
    want = np.asarray(jnp.sum(jnp.asarray(X) ** 2, axis=1))
    np.testing.assert_allclose(x2.numpy(), want, rtol=1e-5)


def test_emulation_refuses_other_product_counts():
    X = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        kernels.rbf_block_3xtf32_emulated(X, X, 0.1, products=2)
