"""Naive Bayes, logistic regression and LDA.

Counterpart of `keystone_tpu/nodes/learning/classifiers.py` (`:27-198`;
reference NaiveBayesModel.scala:12-69, LogisticRegressionModel.scala:
34-94, LinearDiscriminantAnalysis.scala:17-68).

The JAX package densifies a `SparseDataset` on the host before any
device work (`:77-78`, `:162-163`). Here the batch path keeps it CSR on
its device (`data/sparse.py`): every product with X is ``X @ dense`` on
the CSR and every product with Xᵀ is ``Xᵀ @ dense`` on the CSR of Xᵀ,
cuSPARSE SpMM on CUDA, with k (the classes) dense columns. Nothing on
that path densifies X. The single-datum path densifies its one row, as
`_as_dense` does (`:27-38`).

- Naive Bayes: multinomial, Laplace-smoothed. The class sums are
  Xᵀ·onehot, the scores ``log_priors + X·log_condᵀ``.
- Logistic regression: ``num_iters`` steps of the port's copy of optax's
  L-BFGS (`lbfgs.py::lbfgs_minimize`, memory 10, zoom line search, no
  early stop, as `_logreg_fit`'s `lax.scan`, `:98-125`) from W = 0 on
  −Σ mask·(Σ logits·onehot − logsumexp(logits))/count + ½λ‖W‖², whose
  gradient is Xᵀ(mask·(softmax − onehot))/count + λW, in float32 (TF32
  off: JAX's "highest").
- LDA: a host `scipy.linalg.eigh` of the d × d scatter matrices.

On a mesh's data axis (a `SparseDataset` of this rank's rows, or a
`Dataset` placed on the mesh) each fit reduces over every rank as JAX's
does over its row-sharded array (`:64-198`): naive Bayes all-reduces its
class counts and its (k, d) feature counts (JAX's "two masked sharded
reductions"); logistic regression's `SoftmaxObjective` all-reduces its
log-likelihood and gradient in one call an evaluation, so every rank
takes the same L-BFGS steps (as `lbfgs.py::_Objective` does); LDA
collects the rows (`data.numpy()`, the labels gathered alike) and every
rank solves the same host `eigh`. Scores keep the input's placement.
With no mesh the same operations run on one process's rows.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset, HostDataset
from ...data.sparse import SparseDataset
from ...device import resolve_device
from ...parallel.collectives import psum
from ...workflow.pipeline import LabelEstimator, Transformer
from .lbfgs import _dot, lbfgs_minimize
from .pca import PCATransformer


def _as_dense(x, device: torch.device) -> torch.Tensor:
    """One datum as a float32 tensor on ``device``: a 1 × V sparse row
    (from `SparseFeatureVectorizer.apply`) densified to a vector."""
    if sp.issparse(x):
        arr = np.asarray(x.todense(), np.float32)
        x = arr.ravel() if arr.shape[0] == 1 else arr
    if isinstance(x, torch.Tensor) and x.device.type == "meta":
        return x.to(torch.float32)  # the static analyzer's run
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _labels(labels, device: torch.device, data=None) -> torch.Tensor:
    """Class ids from a `Dataset`, a `HostDataset` or a sequence, as an
    int64 vector on ``device``; for a `SparseDataset` ``data`` the ids
    of its rows held here (`SparseDataset.local_rows`)."""
    if isinstance(data, SparseDataset):
        labels = data.local_rows(labels)
    if isinstance(labels, HostDataset):
        labels = labels.items
    elif isinstance(labels, Dataset):
        labels = labels.array
    if isinstance(labels, torch.Tensor):
        return labels.reshape(-1).to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(labels, np.int64).reshape(-1),
                           device=device)


def _rows_and_transpose(data):
    """(X, Xᵀ, row mask as float32, count, mesh) for a `SparseDataset`
    (its device CSRs of the rows held here, all valid; ``count`` every
    rank's) or a dense `Dataset` (its rows held here, padded ones
    masked)."""
    if isinstance(data, SparseDataset):
        X = data.csr()
        return X, data.csr_t(), torch.ones(
            data.count, dtype=torch.float32, device=X.device), data.total, \
            data.mesh
    X = data.array.to(torch.float32)
    return X, X.T, data.mask.to(torch.float32), data.count, data.mesh


def _scores(data, W: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """``data`` @ W (+ bias) as a device `Dataset` in ``data``'s
    placement, the CSR product for a `SparseDataset`."""
    if isinstance(data, SparseDataset):
        out = data.csr() @ W
        return data.rows_dataset(out if bias is None else out + bias)
    if bias is None:
        return data.map_batches(lambda X: X.to(W.dtype) @ W)
    return data.map_batches(lambda X: torch.addmm(bias, X.to(W.dtype), W))


class NaiveBayesModel(Transformer):
    """x → log-posterior vector (NaiveBayesModel.scala:12-40):
    ``log_priors`` (k,) and ``log_cond`` (k, d)."""

    def __init__(self, log_priors: torch.Tensor, log_cond: torch.Tensor):
        self.log_priors = log_priors
        self.log_cond = log_cond
        self._log_cond_t = log_cond.T.contiguous()  # (d, k)

    def apply(self, x):
        x = _as_dense(x, self.log_cond.device)
        out = self.log_priors + torch.atleast_2d(x) @ self._log_cond_t
        return out[0] if x.ndim == 1 else out

    def apply_batch(self, data):
        return _scores(data, self._log_cond_t, self.log_priors)


class NaiveBayesEstimator(LabelEstimator):
    """Multinomial naive Bayes with Laplace smoothing λ
    (NaiveBayesModel.scala:42-69). Labels: class ids; data: nonnegative
    count features, CSR or dense."""

    mesh_aware = True  # both counts all-reduced over the data axis

    def __init__(self, num_classes: int, lam: float = 1.0):
        self.num_classes = num_classes
        self.lam = lam

    def fit(self, data, labels) -> NaiveBayesModel:
        X, Xt, mask, _, mesh = _rows_and_transpose(data)
        y = _labels(labels, X.device, data)
        onehot = F.one_hot(y, self.num_classes).to(torch.float32) \
            * mask[:, None]
        class_counts, feat_counts = psum((onehot.sum(dim=0), Xt @ onehot),
                                         mesh)
        feat_counts = feat_counts.T  # (k, d)
        k, lam = self.num_classes, self.lam
        log_priors = torch.log((class_counts + lam)
                               / (class_counts.sum() + lam * k))
        smoothed = feat_counts + lam
        log_cond = torch.log(smoothed / smoothed.sum(dim=1, keepdim=True))
        return NaiveBayesModel(log_priors, log_cond)


class SoftmaxObjective:
    """The multinomial logistic loss with L2 at W (d, k), and its
    gradient, on device rows X (CSR or dense) and their transpose, in
    `_logreg_fit`'s order of operations. With ``mesh`` the rows are this
    rank's and ``count`` every rank's: the log-likelihood and Xᵀ·resid
    are all-reduced over ``data`` in one call, so every rank reads the
    same value and gradient (JAX's GSPMD all-reduce, `:98-125`)."""

    def __init__(self, X, Xt, onehot: torch.Tensor, mask: torch.Tensor,
                 count: int, lam: float, mesh=None):
        self.X, self.Xt, self.onehot, self.mask = X, Xt, onehot, mask
        self.count, self.lam, self.mesh = count, lam, mesh

    def __call__(self, W: torch.Tensor):
        logits = self.X @ W
        logz = torch.logsumexp(logits, dim=1)
        picked = (logits * self.onehot).sum(dim=1)
        resid = (torch.exp(logits - logz[:, None]) - self.onehot) \
            * (self.mask / self.count)[:, None]
        ll, xt_resid = psum((torch.sum((picked - logz) * self.mask),
                             self.Xt @ resid), self.mesh)
        value = -ll / self.count + 0.5 * self.lam * _dot(W, W)
        grad = torch.add(xt_resid, W, alpha=self.lam)
        return value, grad


class LogisticRegressionModel(Transformer):
    """x → argmax(x @ W) (LogisticRegressionModel.scala:34-60); W is
    (d, k)."""

    def __init__(self, W: torch.Tensor):
        self.W = W

    def apply(self, x):
        return torch.argmax(_as_dense(x, self.W.device) @ self.W, dim=-1)

    def apply_batch(self, data):
        return self.scores(data).map_batches(
            lambda s: torch.argmax(s, dim=-1))

    def scores(self, data) -> Dataset:
        """x @ W for each row."""
        return _scores(data, self.W)


class LogisticRegressionEstimator(LabelEstimator):
    """Multinomial logistic regression by ``num_iters`` L-BFGS steps
    (LogisticRegressionModel.scala:62-94). After a fit,
    ``loss_history`` holds the objective at the start of each step and
    ``linesearch_steps`` each step's evaluations (one synchronizing call
    each, `lbfgs.py::_evaluate`)."""

    mesh_aware = True  # loss and gradient all-reduced over the data axis

    def __init__(self, num_classes: int, lam: float = 0.0,
                 num_iters: int = 50):
        self.num_classes = num_classes
        self.lam = lam
        self.num_iters = num_iters
        self.weight = num_iters
        self.loss_history: List[float] = []
        self.linesearch_steps: List[int] = []

    def objective(self, data, labels) -> SoftmaxObjective:
        X, Xt, mask, count, mesh = _rows_and_transpose(data)
        y = _labels(labels, X.device, data)
        onehot = F.one_hot(y, self.num_classes).to(torch.float32) \
            * mask[:, None]
        return SoftmaxObjective(X, Xt, onehot, mask, count, self.lam, mesh)

    def fit(self, data, labels) -> LogisticRegressionModel:
        objective = self.objective(data, labels)
        W0 = torch.zeros((objective.X.shape[1], self.num_classes),
                         dtype=torch.float32, device=objective.onehot.device)
        W, self.loss_history, self.linesearch_steps = lbfgs_minimize(
            objective, W0, self.num_iters)
        return LogisticRegressionModel(W)


class LinearDiscriminantAnalysis(LabelEstimator):
    """Multiclass LDA by the generalized eigendecomposition of S_W⁻¹S_B
    (LinearDiscriminantAnalysis.scala:17-68), on the host in float64;
    d is small. Returns a `PCATransformer` of the leading ``num_dims``
    directions on the data's device. On a mesh the rows and labels are
    collected (`numpy`, a gather) and every rank solves alike."""

    mesh_aware = True  # the rows collected over the data axis

    def __init__(self, num_dims: int):
        self.num_dims = num_dims

    def fit(self, data, labels) -> PCATransformer:
        X = np.asarray(data.numpy(), np.float64)
        if isinstance(labels, HostDataset):
            labels = labels.gather_items()
        elif isinstance(labels, Dataset):
            labels = labels.numpy()
        y = _labels(labels, torch.device("cpu")).numpy()
        classes = np.unique(y)
        mu = X.mean(axis=0)
        d = X.shape[1]
        Sw = np.zeros((d, d))
        Sb = np.zeros((d, d))
        for c in classes:
            Xc = X[y == c]
            mc = Xc.mean(axis=0)
            Sw += (Xc - mc).T @ (Xc - mc)
            Sb += len(Xc) * np.outer(mc - mu, mc - mu)
        Sw += 1e-6 * np.eye(d)
        vals, vecs = scipy.linalg.eigh(Sb, Sw)
        order = np.argsort(vals)[::-1]
        components = vecs[:, order[:self.num_dims]].astype(np.float32)
        return PCATransformer(torch.from_numpy(components).to(
            resolve_device(data.device)))
