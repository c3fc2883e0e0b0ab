"""Sparse least squares: the port against the JAX package on the CPU.

- `SparseLBFGSwithL2` on both routes (Gram and sparse products), with
  and without an intercept, from a `SparseDataset` and from a
  `PaddedSparseDataset`: W, b and the loss history against JAX's (one
  device), within 1e-5 of max|W| and of the history's largest value.
  Only the order of float32 sums differs; measured about 1e-7.
- Both routes at 80 steps against the float64 closed-form ridge, within
  2e-3 of max|W| (JAX's own tests allow 5e-2).
- One outlier-dense row: the fit succeeds and matches the ridge within
  JAX's 1e-1 (`tests/test_solvers.py::
  test_sparse_lbfgs_outlier_dense_row_falls_back_to_host`), and the
  forced Gram route gives JAX's W (its host-scipy Gram) within 1e-3 of
  max|W| and its history within 5e-3 of the largest value, the last
  value within 1e-5: 120 steps on a d = 1000 system carry the float32
  differences of the two Gram sums further mid-way (measured 1.0e-4 on
  W, 1.6e-3 at step 14, 2e-7 at the end).
- `PaddedSparseDataset` round-trips a CSR, builds the column form on
  the device as the host does, and feeds the fit; `SparseLinearMapper`
  applies as JAX's on one row, several rows, a dense row and batches;
  `LeastSquaresEstimator.fit` survives sparse input on a dense route.
- The automatic route under the H100's analytic weights: the shapes
  the card runs go to the sparse products, dense small ones to Gram.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.sparse import PaddedSparseDataset as JaxPadded
from keystone_tpu.data.sparse import SparseDataset as JaxSparse
from keystone_tpu.nodes.learning import LeastSquaresEstimator as JaxLSE
from keystone_tpu.nodes.learning import SparseLBFGSwithL2 as JaxSparseLBFGS
from keystone_tpu.nodes.learning.linear import (
    SparseLinearMapper as JaxSparseLinearMapper,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.data.sparse import (
    PaddedSparseDataset,
    SparseDataset,
    pad_csr,
    padded_form_ok,
)
from keystone_tpu_torch.nodes.learning import cost_model
from keystone_tpu_torch.nodes.learning.lbfgs import SparseLBFGSwithL2
from keystone_tpu_torch.nodes.learning.least_squares import (
    LeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.learning.linear import (
    LinearMapper,
    SparseLinearMapper,
)

W_REL = 1e-5
HISTORY_REL = 1e-5
RIDGE_REL = 2e-3
OUTLIER_REL = 1e-3
OUTLIER_HISTORY_REL = 5e-3


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


def _problem(n, d, k, density, seed):
    rng = np.random.default_rng(seed)
    dense = (rng.normal(size=(n, d))
             * (rng.random((n, d)) < density)).astype(np.float32)
    return dense, rng.normal(size=(n, k)).astype(np.float32)


def _cpu(x):
    return Dataset(x, device="cpu")


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("method", ["gram", "iterative"])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("form", ["csr", "padded"])
def test_sparse_lbfgs_matches_jax(method, intercept, form):
    dense, Y = _problem(500, 48, 2, 0.1, 17)
    X = sp.csr_matrix(dense)
    with use_mesh(make_mesh(jax.devices()[:1])):
        jest = JaxSparseLBFGS(lam=1.0, num_iters=30, method=method,
                              fit_intercept=intercept)
        jdata = JaxSparse(X) if form == "csr" else JaxPadded.from_csr(X)
        jm = jest.fit(jdata, JaxDataset(Y))
    est = SparseLBFGSwithL2(lam=1.0, num_iters=30, method=method,
                            fit_intercept=intercept)
    data = (SparseDataset(X, device="cpu") if form == "csr"
            else PaddedSparseDataset.from_csr(X, device="cpu"))
    m = est.fit(data, _cpu(Y))
    assert isinstance(m, SparseLinearMapper if form == "csr"
                      else LinearMapper)
    assert est.route == method
    _close(m.W, jm.W, W_REL)
    if intercept:
        _close(m.b, jm.b, W_REL)
    else:
        assert m.b is None and jm.b is None
    _close(est.loss_history, jest.loss_history, HISTORY_REL)


@pytest.mark.parametrize("method", ["gram", "iterative"])
@pytest.mark.parametrize("intercept", [True, False])
def test_sparse_lbfgs_matches_ridge(method, intercept):
    dense, Y = _problem(600, 64, 3, 0.08, 13)
    est = SparseLBFGSwithL2(lam=2.0, num_iters=80, method=method,
                            fit_intercept=intercept, block_rows=128)
    m = est.fit(SparseDataset(sp.csr_matrix(dense), device="cpu"), _cpu(Y))
    W, b = ridge_closed_form(dense.astype(np.float64), Y, 2.0, intercept)
    _close(m.W, W, RIDGE_REL)
    if intercept:
        _close(m.b, b, RIDGE_REL)
    hist = est.loss_history.numpy()
    assert hist[-1] <= hist[0]


def test_sparse_lbfgs_outlier_dense_row():
    rng = np.random.default_rng(11)
    n, d, k = 5000, 1000, 2
    dense = (rng.normal(size=(n, d))
             * (rng.random((n, d)) < 0.002)).astype(np.float32)
    dense[0] = 1.0  # one fully dense row: the padded width is d
    X = sp.csr_matrix(dense)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    assert not padded_form_ok(n, d, X.nnz, "cpu")
    with pytest.raises(ValueError, match="padded_form_ok"):
        PaddedSparseDataset.from_csr(X, device="cpu")
    Wref, _ = ridge_closed_form(dense.astype(np.float64), Y, 1.0)
    est = SparseLBFGSwithL2(lam=1.0, num_iters=120)
    model = est.fit(SparseDataset(X, device="cpu"), _cpu(Y))
    np.testing.assert_allclose(model.W.numpy(), Wref, atol=1e-1, rtol=1e-1)
    # the Gram route from the CSR against JAX's host-scipy Gram
    with use_mesh(make_mesh(jax.devices()[:1])):
        jest = JaxSparseLBFGS(lam=1.0, num_iters=120)
        jm = jest.fit(JaxSparse(X), JaxDataset(Y))
    gram = SparseLBFGSwithL2(lam=1.0, num_iters=120, method="gram")
    gm = gram.fit(SparseDataset(X, device="cpu"), _cpu(Y))
    _close(gm.W, jm.W, OUTLIER_REL)
    _close(gram.loss_history, jest.loss_history, OUTLIER_HISTORY_REL)
    assert float(gram.loss_history[-1]) == pytest.approx(
        float(jest.loss_history[-1]), rel=HISTORY_REL)
    np.testing.assert_allclose(gm.W.numpy(), Wref, atol=1e-1, rtol=1e-1)


@pytest.mark.parametrize("precision,rel", [("high", 1e-3),
                                           ("default", 5e-2)])
def test_gram_precision_modes(precision, rel):
    """TF32 and bfloat16 block products (float32 on the CPU, where TF32
    does not apply; bfloat16 operands there too) stay near the float32
    fit."""
    dense, Y = _problem(400, 32, 2, 0.2, 3)
    X = SparseDataset(sp.csr_matrix(dense), device="cpu")
    exact = SparseLBFGSwithL2(lam=1.0, num_iters=40, method="gram").fit(
        X, _cpu(Y))
    other = SparseLBFGSwithL2(lam=1.0, num_iters=40, method="gram",
                              gram_precision=precision).fit(X, _cpu(Y))
    _close(other.W, exact.W.numpy(), rel)
    with pytest.raises(ValueError):
        SparseLBFGSwithL2(gram_precision="fast")
    with pytest.raises(ValueError):
        SparseLBFGSwithL2(method="newton")


def test_dense_dataset_takes_the_gram_route():
    dense, Y = _problem(300, 20, 2, 1.0, 5)
    est = SparseLBFGSwithL2(lam=0.5, num_iters=60, block_rows=64)
    m = est.fit(_cpu(dense), _cpu(Y))
    assert isinstance(m, LinearMapper) and est.route == "gram"
    W, b = ridge_closed_form(dense.astype(np.float64), Y, 0.5)
    _close(m.W, W, RIDGE_REL)
    _close(m.b, b, RIDGE_REL)


def test_padded_sparse_dataset_round_trip_and_fit():
    dense, Y = _problem(400, 40, 2, 0.12, 19)
    X = sp.csr_matrix(dense)
    ds = PaddedSparseDataset.from_csr(X, device="cpu")
    assert (ds.count, ds.dim, ds.nnz) == (400, 40, X.nnz)
    assert ds.width == int(np.diff(X.indptr).max())
    assert ds.sparsity == pytest.approx(X.nnz / (400 * 40))
    assert int(ds.idx.max()) <= 40 and len(ds) == 400
    # the padded rows give back the CSR
    rows = np.repeat(np.arange(400), ds.width)
    idx, val = ds.idx.numpy().ravel(), ds.val.numpy().ravel()
    keep = idx < 40
    back = sp.csr_matrix((val[keep], (rows[keep], idx[keep])),
                         shape=(400, 40))
    np.testing.assert_array_equal(back.toarray(), dense)
    i2, v2 = pad_csr(X)
    np.testing.assert_array_equal(i2, ds.idx.numpy())
    np.testing.assert_array_equal(v2, ds.val.numpy())
    # the column form built on the device holds the host's, column by
    # column (slot order may differ)
    bare = PaddedSparseDataset(ds.idx, ds.val, 40, nnz=X.nnz)
    built = bare.with_column_form()
    assert built.cidx.shape == ds.cidx.shape
    np.testing.assert_array_equal(np.sort(built.cval.numpy(), axis=1),
                                  np.sort(ds.cval.numpy(), axis=1))
    np.testing.assert_array_equal(np.sort(built.cidx.numpy(), axis=1),
                                  np.sort(ds.cidx.numpy(), axis=1))
    assert built.nbytes == ds.nbytes > bare.nbytes == 8 * 400 * ds.width
    # the padded form feeds the fit as the CSR does; labels may be
    # label-major (k, n)
    padded = SparseLBFGSwithL2(lam=1.0, num_iters=60, method="iterative")
    m_pad = padded.fit(bare, Y.T.copy())
    m_csr = SparseLBFGSwithL2(lam=1.0, num_iters=60,
                              method="iterative").fit(
        SparseDataset(X, device="cpu"), _cpu(Y))
    _close(m_pad.W, m_csr.W.numpy(), 1e-5)
    m_gram = SparseLBFGSwithL2(lam=1.0, num_iters=60, method="gram",
                               block_rows=64).fit(ds, _cpu(Y))
    _close(m_gram.W, m_csr.W.numpy(), 2e-2)


def test_padded_form_ok():
    assert padded_form_ok(1000, 8, 6000, "cpu")
    # above 32 MB and 16× the nonzeros' bytes: declined
    assert not padded_form_ok(100_000, 100, 1000, "cpu")
    # above the device share
    assert not padded_form_ok(10**9, 10, 10**10, "cpu")


def test_sparse_linear_mapper_matches_jax():
    rng = np.random.default_rng(7)
    n, d, k = 100, 30, 4
    dense = (rng.normal(size=(n, d))
             * (rng.random((n, d)) < 0.1)).astype(np.float32)
    X = sp.csr_matrix(dense)
    W = rng.normal(size=(d, k)).astype(np.float32)
    b = rng.normal(size=(k,)).astype(np.float32)
    jm = JaxSparseLinearMapper(W, b)
    m = SparseLinearMapper(torch.from_numpy(W), torch.from_numpy(b))
    for x in (X[3], X[3:6], dense[3], dense[3:6]):
        _close(m.apply(x), jm.apply(x), 1e-6)
    out = m.apply_batch(SparseDataset(X, device="cpu"))
    assert isinstance(out, Dataset)
    _close(out.array, dense @ W + b, 1e-6)
    with use_mesh(make_mesh(jax.devices()[:1])):
        want = jm.apply_batch(JaxSparse(X)).numpy()
    _close(out.array, want, 1e-6)
    _close(m.apply_batch(_cpu(dense)).array, dense @ W + b, 1e-6)
    no_bias = SparseLinearMapper(torch.from_numpy(W))
    _close(no_bias.apply(X[3]), dense[3] @ W, 1e-6)


def test_least_squares_fit_survives_sparse_input_on_a_dense_route():
    """tests/test_solvers.py::test_routing_survives_sparse_input_on_dense_route
    on the port, and the same choice as JAX's."""
    rng = np.random.default_rng(5)
    X = sp.csr_matrix(rng.normal(size=(64, 8)).astype(np.float32))
    Y = rng.normal(size=(64, 2)).astype(np.float32)
    w = (5e-15, 1.25e-12, 1e-11)
    est = LeastSquaresEstimator(lam=1.0, num_chips=8, cpu_weight=w[0],
                                mem_weight=w[1], network_weight=w[2])
    model = est.fit(SparseDataset(X, device="cpu"), _cpu(Y))
    assert est.chosen != "sparse-lbfgs"
    pred = model.apply_batch(SparseDataset(X, device="cpu"))
    assert tuple(pred.array.shape) == (64, 2)
    with use_mesh(make_mesh(jax.devices()[:1])):
        jest = JaxLSE(lam=1.0, num_chips=8, cpu_weight=w[0],
                      mem_weight=w[1], network_weight=w[2])
        jest.fit(JaxSparse(X), JaxDataset(Y))
    assert est.chosen == jest.chosen


def test_least_squares_takes_the_sparse_route_on_sparse_rows():
    dense, Y = _problem(2000, 500, 2, 0.01, 23)
    est = LeastSquaresEstimator(lam=1.0)
    model = est.fit(SparseDataset(sp.csr_matrix(dense), device="cpu"),
                    _cpu(Y))
    assert est.chosen == "sparse-lbfgs"
    assert isinstance(model, SparseLinearMapper)
    assert min(est.costs.values()) == est.costs["sparse-lbfgs"]


@pytest.fixture
def h100_weights(monkeypatch):
    monkeypatch.setattr(cost_model, "resolve_weights",
                        lambda: cost_model.ANALYTIC_CUDA)


def test_route_under_the_card_rates(h100_weights):
    est = SparseLBFGSwithL2(num_iters=20)
    # Amazon at the reference's widths: d = 100,000 (a 40 GB Gram)
    assert est._route(16_000, 100_000, 2, 80) == "iterative"
    # the reference suite's shape, n cut to 200,000, density 0.004
    assert est._route(200_000, 16_384, 2, 66) == "iterative"
    # dense rows below the crossover, and above it
    assert est._route(400, 50, 2, 50) == "gram"
    assert est._route(100_000, 4096, 2, 4096) == "gram"
    assert est._route(100_000, 16_384, 2, 16_384) == "iterative"
    gram, iterative = est.route_seconds(200_000, 16_384, 2, 66)
    assert iterative < gram
    assert SparseLBFGSwithL2(method="gram")._route(
        16_000, 100_000, 2, 80) == "gram"


def _amazon_csr(n_synth, features):
    """JAX's Amazon training and test CSRs at ``features`` common
    features (`tests/test_torch_text_pipelines.py::jax_amazon`'s
    featurizer), with the ±1 indicators of the training labels and the
    test labels."""
    from keystone_tpu.data.dataset import HostDataset as JaxHostDataset
    from keystone_tpu.nodes.util.sparse_features import (
        CommonSparseFeatures as JaxCommon,
    )
    from keystone_tpu.pipelines import text_pipelines as jax_tp
    from test_torch_text_pipelines import _jax_pairs

    labels, docs = jax_tp.synthetic_corpus(n_synth, 2, seed=0)
    n_train = int(0.8 * n_synth)
    train = JaxHostDataset(docs.items[:n_train])
    test = JaxHostDataset(docs.items[n_train:])
    pairs = _jax_pairs()
    vec = JaxCommon(features).fit(pairs(train).get())
    X = vec.apply_batch(pairs(train).get()).matrix
    Xt = vec.apply_batch(pairs(test).get()).matrix
    y = np.asarray(labels.items[:n_train])
    Y = (2.0 * np.eye(2)[y] - 1.0).astype(np.float32)
    return X, Y, Xt, np.asarray(labels.items[n_train:])


def least_squares_objective64(X, Y, W, b, lam):
    """½‖XW + b − Y‖² + ½λ‖W‖² in float64 from a CSR."""
    W = np.asarray(W, np.float64)
    R = X.astype(np.float64) @ W + np.asarray(b, np.float64) - Y
    return float(0.5 * np.sum(R * R) + 0.5 * lam * np.sum(W * W))


def jax_amazon_least_squares(n_synth=20_000, features=100_000, lam=1e-3):
    """JAX's LeastSquaresEstimator (analytic weights, one device) on the
    Amazon training CSR against its ±1 indicators: the route it chose,
    the float64 objective and the test error rate. `chip_smoke.py` pins
    these values at the defaults (``python
    tests/test_torch_sparse_solvers.py``)."""
    X, Y, Xt, yt = _amazon_csr(n_synth, features)
    w = int(np.diff(X.indptr).max())
    with use_mesh(make_mesh(jax.devices()[:1])):
        est = JaxLSE(lam=lam)
        model = est.fit(JaxSparse(X), JaxDataset(Y))
    scores = Xt @ np.asarray(model.W) + np.asarray(model.b)
    route = JaxSparseLBFGS()._route(X.shape[0], X.shape[1], 2, w)
    return {"chosen": est.chosen, "sparse_route": route,
            "shape": list(X.shape), "nnz": X.nnz,
            "objective": least_squares_objective64(X, Y, model.W, model.b,
                                                   lam),
            "test_error": float(np.mean(scores.argmax(1) != yt))}


def test_least_squares_on_amazon_csr_matches_jax(monkeypatch):
    """The pinned computation at 400 documents and 2,000 features: the
    same choice, and the objective within 1e-5 on the sparse-product
    route, which both packages take at the pinned size (JAX's TPU rates
    send this small shape to its Gram route, so JAX's is forced)."""
    monkeypatch.setattr(JaxSparseLBFGS, "_route",
                        lambda self, n, d, k, w: "iterative")
    X, Y, Xt, yt = _amazon_csr(400, 2_000)
    want = jax_amazon_least_squares(400, 2_000)
    est = LeastSquaresEstimator(lam=1e-3)
    chosen = est.optimize(SparseDataset(X, device="cpu"), _cpu(Y), 320)
    model = chosen.fit(SparseDataset(X, device="cpu"), _cpu(Y))
    assert chosen.route == want["sparse_route"] == "iterative"
    assert est.chosen == want["chosen"] == "sparse-lbfgs"
    got = least_squares_objective64(X, Y, model.W.numpy(), model.b.numpy(),
                                    1e-3)
    assert got == pytest.approx(want["objective"], rel=1e-5)
    pred = model.apply_batch(SparseDataset(Xt, device="cpu")).array
    assert float(np.mean(pred.numpy().argmax(1) != yt)) == want["test_error"]


if __name__ == "__main__":
    import json

    print(json.dumps(jax_amazon_least_squares()))
