"""The dense L-BFGS and dual-form least-squares solvers: the port against
the JAX package on the CPU, and L-BFGS against the closed-form ridge.

- `lbfgs_fit` keeps its own copy of optax's L-BFGS (two-loop recursion,
  scaled initial preconditioner, zoom line search): its loss history
  must follow JAX's `_lbfgs_fit` within 1e-5 of the starting value, and
  its W within 1e-4 of max|W|. Only the order of float32 sums differs.
- `DenseLBFGSwithL2` at 60 steps against `ridge_closed_form` (float64),
  within 1e-4: the JAX package's own test of this (`tests/test_solvers.py
  ::test_lbfgs_dense_with_and_without_intercept`) passes on some runs
  and fails on others, so the port is held to the closed form here too.
- `dual_solve` / `LocalLeastSquaresEstimator` against JAX's `_dual_solve`
  within 1e-4 of max|W|, masked rows included, and against the primal
  ridge without intercept.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optax._src import linesearch as optax_linesearch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import (
    LocalLeastSquaresEstimator as JaxLocalLeastSquares,
)
from keystone_tpu.nodes.learning.lbfgs import _lbfgs_fit
from keystone_tpu.nodes.learning.linear import _dual_solve
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.lbfgs import (
    DenseLBFGSwithL2,
    _cubicmin,
    _quadmin,
    lbfgs_fit,
)
from keystone_tpu_torch.nodes.learning.linear import (
    LocalLeastSquaresEstimator,
    dual_solve,
)

HISTORY_REL = 1e-5
W_REL = 1e-4
RIDGE_TOL = 1e-4


def ridge_closed_form(X, Y, lam, intercept=True):
    """Copied from tests/test_solvers.py:22-30."""
    if intercept:
        xm, ym = X.mean(0), Y.mean(0)
        Xc, Yc = X - xm, Y - ym
    else:
        Xc, Yc = X, Y
    W = np.linalg.solve(Xc.T @ Xc + lam * np.eye(X.shape[1]), Xc.T @ Yc)
    b = (ym - xm @ W) if intercept else np.zeros(Y.shape[1])
    return W, b


def _problem(n, d, k, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Wt = rng.normal(size=(d, k)).astype(np.float32)
    Y = (X @ Wt + 0.1 * rng.normal(size=(n, k)) + offset).astype(np.float32)
    return X, Y


def _close_rel(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("masked", [0, 7])
def test_lbfgs_follows_jax(intercept, masked):
    n, lam = 400, 0.05
    X, Y = _problem(n, 60, 5, seed=3, offset=1.5)
    mask = np.ones(n, np.float32)
    if masked:
        mask[-masked:] = 0.0
    count = n - masked
    W, b, values = _lbfgs_fit(jnp.asarray(X), jnp.asarray(Y),
                              jnp.asarray(mask), jnp.float32(lam),
                              jnp.float32(count), 20, 10, intercept)
    got = lbfgs_fit(torch.tensor(X), torch.tensor(Y), torch.tensor(mask),
                    lam, count, 20, 10, intercept)
    values = np.asarray(values)
    assert len(got.loss_history) == 20
    np.testing.assert_allclose(np.array(got.loss_history), values, rtol=0,
                               atol=HISTORY_REL * values[0])
    _close_rel(got.W.numpy(), np.asarray(W), W_REL)
    if intercept:
        _close_rel(got.b.numpy(), np.asarray(b), W_REL)
    else:
        assert got.b is None


@pytest.mark.parametrize("intercept", [True, False])
def test_dense_lbfgs_matches_the_closed_form_ridge(intercept):
    """The JAX package's LBFGS test problem (tests/test_solvers.py:33-40,
    103-118): λ 20, 60 steps."""
    rng = np.random.default_rng(42)
    n, d, k = 200, 24, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    Wtrue = rng.normal(size=(d, k)).astype(np.float32)
    Y = (X @ Wtrue + 0.01 * rng.normal(size=(n, k)) + 1.5).astype(np.float32)
    est = DenseLBFGSwithL2(lam=20.0, num_iters=60, fit_intercept=intercept)
    model = est.fit(Dataset(X, device="cpu"), Dataset(Y, device="cpu"))
    Wref, bref = ridge_closed_form(X.astype(np.float64),
                                   Y.astype(np.float64), 20.0, intercept)
    np.testing.assert_allclose(model.W.numpy(), Wref, atol=RIDGE_TOL,
                               rtol=RIDGE_TOL)
    if intercept:
        np.testing.assert_allclose(model.b.numpy(), bref, atol=RIDGE_TOL,
                                   rtol=RIDGE_TOL)
    else:
        assert model.b is None
    # every step meets the zoom search's sufficient decrease, whose
    # approximate form (optax's approx_dec_rtol) lets a step near the
    # minimum raise the objective by up to 1e-6 of its value
    history = est.loss_history.numpy()
    assert history.shape == (60,)
    assert np.all(np.diff(history) <= 1e-6 * np.abs(history[:-1]))
    assert history[-1] < 0.2 * history[0]
    assert len(est.linesearch_steps) == 60
    assert min(est.linesearch_steps) >= 1


def test_lbfgs_with_no_steps_and_bad_memory():
    X, Y = _problem(20, 4, 2, seed=0)
    got = lbfgs_fit(torch.tensor(X), torch.tensor(Y), torch.ones(20), 1.0,
                    20, 0, 10, True)
    assert got.loss_history == [] and float(got.W.abs().max()) == 0.0
    with pytest.raises(ValueError, match="memory_size"):
        lbfgs_fit(torch.tensor(X), torch.tensor(Y), torch.ones(20), 1.0, 20,
                  3, 0, True)


@pytest.mark.parametrize("args", [
    (0.0, 1.0, -2.0, 1.0, 0.5, 0.5, 0.9),
    (0.2, 3.0, -0.5, 1.4, 2.7, 0.9, 2.0),
    (1.0, -1.0, 4.0, 0.0, 3.0, 2.0, 0.5),
])
def test_interpolation_steps_match_optax(args):
    """The zoom search's cubic and quadratic minimizers, in float32."""
    a, fa, fpa, b, fb, c, fc = (np.float32(v) for v in args)
    want_c = float(optax_linesearch._cubicmin(a, fa, fpa, b, fb, c, fc))
    want_q = float(optax_linesearch._quadmin(a, fa, fpa, b, fb))
    with np.errstate(all="ignore"):
        got_c = float(_cubicmin(a, fa, fpa, b, fb, c, fc))
        got_q = float(_quadmin(a, fa, fpa, b, fb))
    np.testing.assert_allclose(got_q, want_q, rtol=1e-6)
    if np.isnan(want_c):
        assert np.isnan(got_c)
    else:
        np.testing.assert_allclose(got_c, want_c, rtol=1e-5)


@pytest.mark.parametrize("masked", [0, 9])
def test_dual_solve_matches_jax(masked):
    """d ≫ n; masked rows get no weight in either package."""
    n, lam = 64, 1e-3
    X, Y = _problem(n, 256, 4, seed=5)
    mask = np.ones(n, np.float32)
    if masked:
        mask[:masked] = 0.0
    want = np.asarray(_dual_solve(jnp.asarray(X), jnp.asarray(Y),
                                  jnp.asarray(mask), jnp.float32(lam)))
    got, info = dual_solve(torch.tensor(X), torch.tensor(Y),
                           torch.tensor(mask), lam)
    assert int(info) == 0
    _close_rel(got.numpy(), want, W_REL)


def test_local_least_squares_estimator_matches_jax_and_the_primal():
    n, lam = 64, 1e-3
    X, Y = _problem(n, 256, 4, seed=6)
    model = LocalLeastSquaresEstimator(lam).fit(Dataset(X, device="cpu"),
                                                Dataset(Y, device="cpu"))
    ref = JaxLocalLeastSquares(lam).fit(JaxDataset(X), JaxDataset(Y))
    _close_rel(model.W.numpy(), np.asarray(ref.W), W_REL)
    assert model.b is None
    primal, _ = ridge_closed_form(X.astype(np.float64),
                                  Y.astype(np.float64), lam,
                                  intercept=False)
    _close_rel(model.W.numpy(), primal, W_REL)


def test_local_least_squares_raises_when_not_positive_definite():
    X, Y = _problem(16, 32, 2, seed=1)
    with pytest.raises(torch.linalg.LinAlgError, match="dual system"):
        LocalLeastSquaresEstimator(-1e6).fit(Dataset(X, device="cpu"),
                                             Dataset(Y, device="cpu"))
