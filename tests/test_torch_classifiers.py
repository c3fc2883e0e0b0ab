"""Naive Bayes, logistic regression, LDA and the binary evaluator: the
port against the JAX package on the CPU.

- Naive Bayes, CSR or dense: ``log_cond`` and ``log_priors`` within 1e-5
  of JAX's (float32 class sums in another order: numpy's dense product
  there, the CSR product here), the scores within 1e-6 of max|score|,
  the same argmax.
- Logistic regression: the port's copy of optax's L-BFGS on the softmax
  objective against `_logreg_fit` (50 steps, λ 1e-3). The loss at the
  start of each step within 1e-5 of the starting value of JAX's (taken
  from a copy of `_logreg_fit`'s scan that also keeps each step's value,
  and whose W equals `_logreg_fit`'s), the final objective within 1e-5
  relative, W within 1e-4 of max|W| and the same predictions. On these
  separable sets the objective flattens, and the late steps search along
  directions where float32 rounding of either side moves W, not the
  objective, so W is held less tightly than the objective.
- LDA: both packages solve the same float64 problem with scipy: within
  1e-6.
- The batch paths never densify X: a test replaces every densifying call
  with one that fails.
"""

import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.sparse import SparseDataset as JaxSparseDataset
from keystone_tpu.evaluation.binary import (
    BinaryClassifierEvaluator as JaxBinaryEvaluator,
)
from keystone_tpu.nodes.learning.classifiers import (
    LinearDiscriminantAnalysis as JaxLDA,
    NaiveBayesEstimator as JaxNaiveBayes,
    _logreg_fit,
)
from keystone_tpu.pipelines.text_pipelines import (
    synthetic_corpus as jax_synthetic_corpus,
)
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.data.sparse import SparseDataset
from keystone_tpu_torch.evaluation.binary import (
    BinaryClassifierEvaluator,
    BinaryClassifierMetrics,
)
from keystone_tpu_torch.nodes.learning.classifiers import (
    LinearDiscriminantAnalysis,
    LogisticRegressionEstimator,
    LogisticRegressionModel,
    NaiveBayesEstimator,
)
from keystone_tpu_torch.nodes.util.sparse_features import (
    CommonSparseFeatures,
)
from keystone_tpu_torch.pipelines import text_pipelines as tp

NB_LOG_TOL = 1e-5
NB_SCORE_REL = 1e-6
LR_HISTORY_REL = 1e-5
LR_OBJECTIVE_REL = 1e-5
LR_W_REL = 1e-4
LDA_TOL = 1e-6
CPU = torch.device("cpu")


def _text_csr(n, num_classes, seed, vec=None, common=2_000):
    """A small corpus's √TF CSR (the port's featurizer, equal to JAX's:
    tests/test_torch_text.py) over ``vec``'s vocabulary, or one fit on
    it; its labels; the vectorizer."""
    labels, docs = jax_synthetic_corpus(n, num_classes, vocab_size=120,
                                        doc_len=30, seed=seed)
    pairs = tp.text_featurizer()(HostDataset(docs.items, device="cpu")).get()
    vec = vec or CommonSparseFeatures(common).fit(pairs)
    return vec.apply_batch(pairs), np.asarray(labels.items, np.int64), vec


def _noisy_csr(n, d, k, seed):
    """Nonnegative sparse rows whose classes overlap (not separable)."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    X[rng.random((n, d)) < 0.8] = 0.0
    y = np.argmax(X @ rng.normal(size=(d, k)) + rng.normal(size=(n, k)), 1)
    return SparseDataset(sp.csr_matrix(X), device="cpu"), y.astype(np.int64)


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_naive_bayes_equals_jax(dense):
    X, y, _ = _text_csr(150, 4, seed=0)
    Xd = X.matrix.toarray()
    if dense:
        data = Dataset(Xd, device="cpu")
        jmodel = JaxNaiveBayes(4).fit(JaxDataset(Xd), JaxDataset(
            y.astype(np.int32)))
    else:
        data = X
        jmodel = JaxNaiveBayes(4).fit(JaxSparseDataset(X.matrix), y)
    model = NaiveBayesEstimator(4).fit(data, HostDataset(list(y)))
    np.testing.assert_allclose(model.log_priors.numpy(),
                               np.asarray(jmodel.log_priors), rtol=0,
                               atol=NB_LOG_TOL)
    np.testing.assert_allclose(model.log_cond.numpy(),
                               np.asarray(jmodel.log_cond), rtol=0,
                               atol=NB_LOG_TOL)
    got = model.apply_batch(data).numpy()
    want = np.asarray(jmodel.apply_batch(JaxSparseDataset(X.matrix)).array)[
        :X.count]
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=NB_SCORE_REL * np.abs(want).max())
    # one datum: the 1 × V CSR row, densified, scores as its batch row
    one = model.apply(X.matrix[5])
    assert one.shape == (4,)
    np.testing.assert_allclose(one.numpy(), got[5], rtol=0,
                               atol=NB_SCORE_REL * np.abs(want).max())


def test_naive_bayes_smoothing_and_priors_by_hand():
    X = SparseDataset(np.array([[2, 0, 1], [0, 3, 0], [1, 1, 0]],
                               np.float32), device="cpu")
    model = NaiveBayesEstimator(2, lam=1.0).fit(X, [0, 1, 0])
    np.testing.assert_allclose(model.log_priors.numpy(),
                               np.log([3 / 5, 2 / 5]), rtol=1e-6)
    np.testing.assert_allclose(
        model.log_cond.numpy(),
        np.log([[4 / 8, 2 / 8, 2 / 8], [1 / 6, 4 / 6, 1 / 6]]), rtol=1e-6)


def _jax_logreg_history(X, y, lam, num_classes, num_iters):
    """`_logreg_fit` (`classifiers.py:98-125`) with each step's value
    kept: (W, values)."""
    with jax.default_matmul_precision("highest"):
        n, d = X.shape
        mask = jnp.ones(n, X.dtype)
        onehot = jax.nn.one_hot(y, num_classes) * mask[:, None]

        def loss(W):
            logits = X @ W
            logz = jax.scipy.special.logsumexp(logits, axis=1)
            ll = jnp.sum((jnp.sum(logits * onehot, axis=1) - logz) * mask)
            return -ll / jnp.sum(mask) + 0.5 * lam * jnp.sum(W * W)

        opt = optax.lbfgs()
        W0 = jnp.zeros((d, num_classes), X.dtype)
        vg = optax.value_and_grad_from_state(loss)

        def step(carry, _):
            W, state = carry
            value, grad = vg(W, state=state)
            updates, state = opt.update(grad, state, W, value=value,
                                        grad=grad, value_fn=loss)
            return (optax.apply_updates(W, updates), state), value

        (W, _), values = jax.jit(lambda: jax.lax.scan(
            step, (W0, opt.init(W0)), None, length=num_iters))()
        return np.asarray(W), np.asarray(values)


def _objective64(X: sp.csr_matrix, y, W, lam):
    """The softmax objective in float64 from the CSR."""
    L = X.astype(np.float64) @ W.astype(np.float64)
    m = L.max(1, keepdims=True)
    logz = (m + np.log(np.exp(L - m).sum(1, keepdims=True)))[:, 0]
    return (-np.sum(L[np.arange(len(y)), y] - logz) / len(y)
            + 0.5 * lam * np.sum(W.astype(np.float64) ** 2))


@pytest.mark.parametrize("case", ["text2", "text4", "noisy3"])
def test_logistic_regression_equals_jax(case):
    if case == "noisy3":
        X, y = _noisy_csr(200, 60, 3, seed=2)
        k = 3
    else:
        k = int(case[-1])
        X, y, vec = _text_csr(160, k, seed=1)
    lam, iters = 1e-3, 50
    Xd = jnp.asarray(X.matrix.toarray())
    W_jax = np.asarray(_logreg_fit(Xd, jnp.asarray(y.astype(np.int32)),
                                   jnp.ones(X.count, jnp.float32),
                                   jnp.float32(lam), k, iters))
    W_copy, hist_jax = _jax_logreg_history(Xd, jnp.asarray(y), lam, k, iters)
    np.testing.assert_array_equal(W_copy, W_jax)

    est = LogisticRegressionEstimator(k, lam=lam, num_iters=iters)
    model = est.fit(X, Dataset(y.astype(np.int32), device="cpu"))
    W = model.W.numpy()
    assert len(est.loss_history) == iters == len(est.linesearch_steps)
    np.testing.assert_allclose(est.loss_history, hist_jax, rtol=0,
                               atol=LR_HISTORY_REL * hist_jax[0])
    obj, obj_jax = (_objective64(X.matrix, y, W, lam),
                    _objective64(X.matrix, y, W_jax, lam))
    assert abs(obj / obj_jax - 1.0) <= LR_OBJECTIVE_REL, (obj, obj_jax)
    np.testing.assert_allclose(W, W_jax, rtol=0,
                               atol=LR_W_REL * np.abs(W_jax).max())
    Xt = _noisy_csr(80, 60, 3, seed=3)[0] if case == "noisy3" else \
        _text_csr(60, k, seed=4, vec=vec)[0]
    pred = model.apply_batch(Xt).numpy()
    np.testing.assert_array_equal(pred, (Xt.matrix @ W_jax).argmax(1))
    np.testing.assert_allclose(model.scores(Xt).numpy(), Xt.matrix @ W,
                               rtol=1e-6, atol=1e-6)
    assert int(model.apply(Xt.matrix[0])) == pred[0]


def test_logistic_regression_dense_input_equals_csr():
    X, y = _noisy_csr(90, 30, 3, seed=5)
    W_csr = LogisticRegressionEstimator(3, lam=1e-2, num_iters=15).fit(
        X, y).W.numpy()
    W_dense = LogisticRegressionEstimator(3, lam=1e-2, num_iters=15).fit(
        X.densify(), y).W.numpy()
    np.testing.assert_allclose(W_dense, W_csr, rtol=0,
                               atol=1e-4 * np.abs(W_csr).max())


def test_logistic_regression_model_from_weights():
    W = torch.tensor([[1.0, -1.0], [0.0, 2.0]])
    model = LogisticRegressionModel(W)
    X = Dataset(np.array([[1.0, 0.0], [0.0, 1.0]], np.float32),
                device="cpu")
    np.testing.assert_array_equal(model.apply_batch(X).numpy(), [0, 1])
    assert int(model.apply(np.array([3.0, 0.5], np.float32))) == 0


def test_batch_paths_never_densify(monkeypatch):
    X, y, vec = _text_csr(120, 3, seed=6)
    Xt = _text_csr(40, 3, seed=7, vec=vec)[0]

    def refuse(*args, **kwargs):
        raise AssertionError("the batch path densified the features")

    monkeypatch.setattr(torch.Tensor, "to_dense", refuse)
    monkeypatch.setattr(SparseDataset, "densify", refuse)
    monkeypatch.setattr(sp.csr_matrix, "todense", refuse)
    monkeypatch.setattr(sp.csr_matrix, "toarray", refuse)
    nb = NaiveBayesEstimator(3).fit(X, y)
    assert nb.apply_batch(Xt).array.shape == (40, 3)
    lr = LogisticRegressionEstimator(3, lam=1e-3, num_iters=5).fit(X, y)
    assert lr.apply_batch(Xt).array.shape == (40,)
    assert lr.scores(Xt).array.shape == (40, 3)


def test_lda_equals_jax():
    rng = np.random.default_rng(10)
    means = rng.normal(size=(3, 6)) * 3
    y = rng.integers(0, 3, 90)
    X = (means[y] + rng.normal(size=(90, 6))).astype(np.float32)
    got = LinearDiscriminantAnalysis(2).fit(Dataset(X, device="cpu"), y)
    want = JaxLDA(2).fit(JaxDataset(X), y)
    np.testing.assert_allclose(got.components.numpy(),
                               np.asarray(want.components), rtol=0,
                               atol=LDA_TOL)
    proj = got.apply_batch(Dataset(X, device="cpu")).numpy()
    np.testing.assert_allclose(proj, X @ np.asarray(want.components),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pred,actual,table", [
    ([1, 1, 0, 0, 1, 0], [1, 0, 0, 1, 1, 0], (2, 1, 2, 1)),
    ([0, 0, 0], [0, 0, 0], (0, 0, 3, 0)),
    ([1, 1], [0, 0], (0, 2, 0, 0)),
    ([], [], (0, 0, 0, 0)),
])
def test_binary_evaluator_on_hand_made_tables(pred, actual, table):
    m = BinaryClassifierEvaluator()(np.array(pred, int),
                                    torch.tensor(actual))
    j = JaxBinaryEvaluator()(np.array(pred, int), np.array(actual, int))
    assert (m.tp, m.fp, m.tn, m.fn) == table == (j.tp, j.fp, j.tn, j.fn)
    for name in ("accuracy", "precision", "recall", "specificity", "f1"):
        assert getattr(m, name) == getattr(j, name), name
    if table == (2, 1, 2, 1):
        assert m.accuracy == 4 / 6 and m.precision == 2 / 3
        assert m.recall == 2 / 3 and m.f1 == pytest.approx(2 / 3)
    if table == (0, 2, 0, 0):
        assert m.precision == 0.0 and m.recall == 1.0 and m.f1 == 0.0


def test_binary_evaluator_takes_datasets():
    preds = Dataset(np.array([1, 0, 1], np.int64), device="cpu")
    m = BinaryClassifierEvaluator()(preds, HostDataset([True, False, False]))
    assert m == BinaryClassifierMetrics(tp=1.0, fp=1.0, tn=1.0, fn=0.0)
