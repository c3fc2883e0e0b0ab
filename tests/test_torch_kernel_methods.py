"""The port's RBF block, linear solver and kernel ridge regression
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages. On
the CPU the port's `rbf_block` runs its plain version; JAX's Pallas RBF
kernel runs in interpret mode, as `tests/test_pallas_ops.py` runs it.
The JAX package pads its datasets to its 8-device test mesh; its padded
rows carry zero weight, so the port's results are held against JAX's
valid rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning.kernels import (
    GaussianKernelGenerator as JaxGaussianKernelGenerator,
    KernelRidgeRegression as JaxKernelRidgeRegression,
)
from keystone_tpu.nodes.learning.linear import (
    LinearMapEstimator as JaxLinearMapEstimator,
)
from keystone_tpu.ops import rbf_block_pallas
from keystone_tpu.ops import rbf_block_reference as jax_rbf_block_reference
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import kernels as port_kernels
from keystone_tpu_torch.nodes.learning import (
    BlockKernelMatrix,
    GaussianKernelGenerator,
    KernelRidgeRegression,
    LinearMapEstimator,
)
from keystone_tpu_torch.ops import kernels


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,n,d", [
    (70, 33, 50),      # ragged on every axis of the JAX tiling
    (130, 200, 300),   # two row tiles, two column tiles, ragged depth
    (9, 200, 513),     # a depth loop with a ragged last step
])
def test_rbf_block_reference_matches_jax(m, n, d):
    """The port's plain version against JAX's kernel in interpret mode
    (bm 64, bn 128, bk 256) and JAX's reference: 1e-5, the limit of
    tests/test_pallas_ops.py:52-60."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    gamma = 0.07 * 50.0 / d
    got = kernels.rbf_block(_t(X), _t(Y), gamma).numpy()
    want = np.asarray(rbf_block_pallas(jnp.asarray(X), jnp.asarray(Y), gamma,
                                       bm=64, bn=128, bk=256, interpret=True))
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jax_rbf_block_reference(jnp.asarray(X),
                                                jnp.asarray(Y), gamma)),
        rtol=1e-5, atol=1e-5)


def test_rbf_block_diagonal_is_one():
    """x against itself: the distance cancels to at most fp32 rounding,
    clamped at 0, so the diagonal is 1 to within that rounding."""
    X = _t(np.random.default_rng(2).normal(size=(40, 64)).astype(np.float32))
    K = kernels.rbf_block(X, X, 0.01)
    np.testing.assert_allclose(torch.diagonal(K).numpy(), 1.0, atol=1e-5)


def _regression(n, d, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    Y = (2.0 * np.eye(k)[labels] - 1.0).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_map_estimator_matches_jax(fit_intercept):
    """Normal equations with and without the intercept's Gram
    correction: W and b within 1e-4 of their largest entry."""
    X, Y = _regression(200, 24, 5, 3)
    X += 0.5  # a mean for the intercept to take up
    jmodel = JaxLinearMapEstimator(0.5, fit_intercept).fit(
        JaxDataset.from_numpy(X), JaxDataset.from_numpy(Y))
    model = LinearMapEstimator(0.5, fit_intercept).fit(
        Dataset(X, device="cpu"), Dataset(Y, device="cpu"))
    jW = np.asarray(jmodel.W)
    np.testing.assert_allclose(model.W.numpy(), jW, rtol=0,
                               atol=1e-4 * float(np.abs(jW).max()))
    if fit_intercept:
        jb = np.asarray(jmodel.b)
        np.testing.assert_allclose(model.b.numpy(), jb, rtol=0,
                                   atol=1e-4 * float(np.abs(jb).max()))
    else:
        assert model.b is None and jmodel.b is None
    x = Dataset(X[:7], device="cpu")
    np.testing.assert_allclose(
        model.apply_batch(x).numpy(),
        np.asarray(jmodel.apply_batch(JaxDataset.from_numpy(X[:7])).numpy()),
        rtol=0, atol=1e-4 * float(np.abs(Y).max()))


# n = 300 with 64-row blocks: five blocks, the last one repeating 20 ids
KRR = dict(n=300, d=16, k=10, gamma=0.1, lam=1.0, block=64, epochs=2)


@pytest.fixture(scope="module")
def krr_fit():
    X, Y = _regression(KRR["n"], KRR["d"], KRR["k"], 5)
    jmodel = JaxKernelRidgeRegression(
        KRR["gamma"], KRR["lam"], KRR["block"], KRR["epochs"]).fit(
            JaxDataset.from_numpy(X), JaxDataset.from_numpy(Y))
    return X, Y, jmodel


def _port_krr(X, Y, **kw):
    est = KernelRidgeRegression(KRR["gamma"], KRR["lam"], KRR["block"],
                                KRR["epochs"], **kw)
    return est.fit(Dataset(X, device="cpu"), Dataset(Y, device="cpu"))


def test_krr_fit_matches_jax(krr_fit):
    """Two epochs of block Gauss-Seidel in the same block order, the
    last block of each epoch repeating ids: alpha within 1e-4 of its
    largest entry. Repeated ids' updates must add up, as JAX's
    ``.at[ids].add`` adds them."""
    X, Y, jmodel = krr_fit
    model = _port_krr(X, Y)
    jalpha = np.asarray(jmodel.alpha)[:KRR["n"]]
    assert np.all(np.asarray(jmodel.alpha)[KRR["n"]:] == 0.0)
    np.testing.assert_allclose(model.alpha.numpy(), jalpha, rtol=0,
                               atol=1e-4 * float(np.abs(jalpha).max()))


def test_krr_repeated_ids_add_up():
    """One step over a block that names row 0 twice adds the updates of
    both its rows to alpha[0], as JAX's ``alpha.at[ids].add`` does."""
    X, Y = _regression(8, 4, 2, 6)
    Xt, Yt = _t(X), _t(Y)
    mask = torch.ones(8)
    ids = torch.tensor([0, 3, 0])
    alpha, KA = torch.zeros((8, 2)), torch.zeros((8, 2))
    port_kernels.krr_step(None, Xt, Yt, mask, alpha, KA, 0.5, 0.2, ids)
    Kb = kernels.rbf_block_reference(Xt, Xt[ids], 0.2)
    A = Kb[ids] + 0.5 * torch.eye(3)
    delta = torch.linalg.solve(A, Yt[ids])
    torch.testing.assert_close(alpha[0], delta[0] + delta[2])
    torch.testing.assert_close(alpha[3], delta[1])
    torch.testing.assert_close(KA, Kb @ delta)


def test_krr_checkpoint_resume_gives_the_same_alpha(tmp_path, monkeypatch,
                                                    krr_fit):
    """A fit cut after seven of its ten block steps resumes from the
    checkpoint of step six and ends with the alpha of an uncut fit; the
    completed fit deletes its checkpoint."""
    X, Y, _ = krr_fit
    whole = _port_krr(X, Y).alpha.numpy()
    real_step, steps = port_kernels.krr_step, []

    class Cut(Exception):
        pass

    def cut_after_seven(*args):
        if len(steps) == 7:
            raise Cut()
        steps.append(1)
        real_step(*args)

    monkeypatch.setattr(port_kernels, "krr_step", cut_after_seven)
    with pytest.raises(Cut):
        _port_krr(X, Y, checkpoint_dir=str(tmp_path),
                  blocks_before_checkpoint=3)
    saved = list(tmp_path.glob("*.npz"))
    assert len(saved) == 1
    state = np.load(saved[0])
    assert (int(state["epoch"]), int(state["block"])) == (1, 1)
    monkeypatch.setattr(port_kernels, "krr_step", real_step)
    resumed = _port_krr(X, Y, checkpoint_dir=str(tmp_path),
                        blocks_before_checkpoint=3).alpha.numpy()
    np.testing.assert_array_equal(resumed, whole)
    assert not list(tmp_path.glob("*.npz"))


def test_kernel_block_linear_mapper_matches_jax(krr_fit):
    """The blocked apply over 64-row train blocks, the last one (44 rows)
    zero-padded, with JAX's fitted anchors and alpha carried across:
    scores within 1e-5 of their largest magnitude."""
    X, _, jmodel = krr_fit
    Xtest = np.random.default_rng(7).normal(size=(50, KRR["d"])).astype(
        np.float32)
    mapper = convert.kernel_mapper(np.asarray(jmodel.train_X)[:KRR["n"]],
                                   np.asarray(jmodel.alpha)[:KRR["n"]],
                                   KRR["gamma"], KRR["block"], device="cpu")
    got = mapper.apply_batch(Dataset(Xtest, device="cpu")).numpy()
    want = np.asarray(jmodel.apply_batch(
        JaxDataset.from_numpy(Xtest)).numpy())
    assert got.shape == want.shape == (50, KRR["k"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_gaussian_kernel_generator_and_block_matrix_match_jax():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(30, 6)).astype(np.float32)
    Q = rng.normal(size=(5, 6)).astype(np.float32)
    got = GaussianKernelGenerator(0.3).fit(Dataset(X, device="cpu")) \
        .apply_batch(Dataset(Q, device="cpu")).numpy()
    want = np.asarray(JaxGaussianKernelGenerator(0.3).fit(
        JaxDataset.from_numpy(X)).apply_batch(
            JaxDataset.from_numpy(Q)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    matrix = BlockKernelMatrix(_t(X), 0.3, cache_blocks=True)
    block = matrix.block(1, 8)
    assert matrix.block(1, 8) is block
    np.testing.assert_allclose(
        block.numpy(),
        np.asarray(jax_rbf_block_reference(jnp.asarray(X),
                                           jnp.asarray(X[8:16]), 0.3)),
        rtol=1e-5, atol=1e-6)
