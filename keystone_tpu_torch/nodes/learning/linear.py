"""Linear models and the exact least-squares solver.

Counterpart of `LinearMapper` (`:38-101`) and `LinearMapEstimator` with
`_normal_equations` (`:104-168`) in `keystone_tpu/nodes/learning/linear.py`
(reference nodes/learning/LinearMapper.scala:18-161). The normal
equations are one Gram product and one Cholesky solve in true float32
(TF32 off, `device.py`), as the JAX package pins ``Precision.HIGHEST``
and solves with ``assume_a="pos"``. The intercept comes from the Gram
correction Xcᵀ Xc = XᵀX − n·x̄x̄ᵀ rather than a centred copy of X.
`LocalLeastSquaresEstimator` with `dual_solve` (`:216-255`) is the dual
form for d ≫ n: the n×n kernel system (XXᵀ + λI)α = Y by one
`cholesky_ex` and `cholesky_solve`, its factorization checked once a
fit, then W = Xᵀα. `SparseLinearMapper` (`:171-213`) applies a dense
model to sparse rows: JAX multiplies on the host, as the TPU has no
efficient sparse GEMM (`:174-178`); on the card the product is the
dataset's device CSR times W (cuSPARSE SpMM), as `classifiers.py` does.

On a ``(data, model)`` mesh (JAX's ``x_sharding``, `:104-160`): the
Gram ``XᵀX`` has a block for every pair of model shards, each the
product of two shards' columns, so the columns have to meet; the exact
fit takes its features gathered over ``model`` (one all-gather, as a
stage that is not ``model_aware``) and then solves as on the data axis.
`LinearMapper` applies to a tile as `BlockLinearMapper` does: the
tile's partial ``X·W`` all-reduced over ``model``.
"""

from __future__ import annotations

from typing import Optional

import scipy.sparse as sp
import torch

from ...data.dataset import Dataset
from ...data.sparse import SparseDataset, _to_torch_csr
from ...parallel.collectives import psum
from ...telemetry.instrument import record_dispatch
from ...workflow.pipeline import LabelEstimator, Transformer
from .block_ls import apply_on_tile, raise_if_unfactored


class LinearMapper(Transformer):
    """y = xW (+ b) (LinearMapper.scala:18-63)."""

    precision_tolerance = "exact"  # solver apply: f32/HIGHEST inputs

    chunkable = True  # per-item: distributes over chunks

    fusable = True  # a GEMM (the port's mapper carries no feature scaler)

    model_aware = True  # a tile's partial product, all-reduced over model

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None):
        self.W = W
        self.b = b

    def batch_fn(self):
        if self.b is None:
            return lambda x: x @ self.W
        return lambda x: x @ self.W + self.b

    def apply_batch(self, data):
        if getattr(data, "tiled", False):
            return apply_on_tile(data, self.W, self.b)
        return super().apply_batch(data)

    def fuse(self):
        # JAX's key without a feature scaler (`:57-63`): the port's
        # mapper carries none
        return ("LinearMapper", self.b is not None), (self.W, self.b)


class SparseLinearMapper(Transformer):
    """y = xW (+ b) for sparse rows (SparseLinearMapper.scala:13-50).

    `apply` takes one scipy sparse row (its nonzeros index W's rows), a
    sparse matrix of rows, or a dense row or matrix; `apply_batch` a
    `SparseDataset` (its CSR on the device times W, the rows in its
    placement) or a dense `Dataset` (as `LinearMapper`)."""

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None):
        self.W = W
        self.b = b

    def _bias(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.b is None else out + self.b

    def apply(self, x):
        dev = self.W.device
        if sp.issparse(x):
            rows = sp.csr_matrix(x)
            if rows.shape[0] == 1:
                vals = torch.as_tensor(rows.data, dtype=self.W.dtype,
                                       device=dev)
                idx = torch.as_tensor(rows.indices, dtype=torch.int64,
                                      device=dev)
                return self._bias(vals @ self.W[idx])
            return self._bias(_to_torch_csr(rows, dev) @ self.W)
        return self._bias(torch.as_tensor(x, device=dev).to(self.W.dtype)
                          @ self.W)

    def apply_batch(self, data):
        if isinstance(data, SparseDataset):
            return data.rows_dataset(self._bias(data.csr() @ self.W))
        return LinearMapper(self.W, self.b).apply_batch(data)


def normal_equations(X: torch.Tensor, Y: torch.Tensor, count: int,
                     lam: float, fit_intercept: bool,
                     mask: Optional[torch.Tensor] = None, mesh=None):
    """(W, b) minimizing ‖XW + b − Y‖² + lam‖W‖² from the Gram matrix
    (`linear.py:108-130`); b is zeros without an intercept. With
    ``mesh`` (`:100-160` under GSPMD), ``X`` and ``Y`` are this rank's
    rows, ``mask`` (None: all valid) its valid ones, ``count`` the global
    count: XᵀX, XᵀY and the column sums of the valid rows are all-reduced
    over ``data`` in one call, and every rank solves the same system."""
    if mask is not None:
        m = mask.to(X.dtype)[:, None]
        X, Y = X * m, Y * m
    A = X.T @ X
    B = X.T @ Y
    d = X.shape[1]
    sx = sy = None
    if fit_intercept:
        sx, sy = X.sum(dim=0), Y.sum(dim=0)
    if mesh is not None:
        if fit_intercept:
            A, B, sx, sy = psum((A, B, sx, sy), mesh)
        else:
            A, B = psum((A, B), mesh)
    if fit_intercept:
        xm = sx / count
        ym = sy / count
        A = A - count * torch.outer(xm, xm)
        B = B - count * torch.outer(xm, ym)
    A = A + lam * torch.eye(d, dtype=X.dtype, device=X.device)
    W = torch.cholesky_solve(B, torch.linalg.cholesky(A))
    if fit_intercept:
        b = ym - xm @ W
    else:
        b = torch.zeros(Y.shape[1], dtype=X.dtype, device=X.device)
    return W, b


class LinearMapEstimator(LabelEstimator):
    """Exact OLS/ridge by the normal equations
    (LinearMapper.scala:69-161)."""

    precision_tolerance = "exact"  # exact normal equations

    fusable_fit = True  # always fits a LinearMapper

    mesh_aware = True  # the Gram all-reduced over the data axis

    def __init__(self, lam: float = 0.0, fit_intercept: bool = True):
        self.lam = lam
        self.fit_intercept = fit_intercept

    def abstract_fit(self, in_specs):
        from ...analysis.specs import supervised_fit_spec

        return supervised_fit_spec(in_specs, self.label)

    def fit(self, data, labels) -> LinearMapper:
        record_dispatch()  # one batched call (JAX :149)
        W, b = normal_equations(data.array, labels.array.to(data.array.dtype),
                                data.count, self.lam, self.fit_intercept,
                                data.mask if data.has_padding else None,
                                data.mesh)
        return LinearMapper(W, b if self.fit_intercept else None)


def dual_solve(X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
               lam: float):
    """(W, info): W = Xmᵀα with (Xm Xmᵀ + lam·I)α = Y·mask, Xm the rows
    of X under ``mask`` (`_dual_solve_impl`, `:216-230`); no intercept.
    ``info`` is `cholesky_ex`'s 0-d int32 on X's device, nonzero where
    the system was not positive definite."""
    m = mask.to(X.dtype)[:, None]
    Xm = X * m
    K = Xm @ Xm.T
    K.diagonal().add_(lam)
    chol, info = torch.linalg.cholesky_ex(K)
    alpha = torch.cholesky_solve(Y.to(X.dtype) * m, chol)
    return Xm.T @ alpha, info


class LocalLeastSquaresEstimator(LabelEstimator):
    """Dual-form ridge for d ≫ n: the n×n kernelized system solved on one
    device (LocalLeastSquaresEstimator.scala:16-61). JAX's solve reads
    the whole array (`:234-255`); on a mesh's data axis the rows and
    labels are gathered (`Dataset.gather`, padding dropped) and every
    rank solves one process's system."""

    fusable_fit = True  # always fits a LinearMapper

    mesh_aware = True  # the rows gathered over the data axis

    def __init__(self, lam: float = 0.0):
        self.lam = lam

    def abstract_fit(self, in_specs):
        from ...analysis.specs import supervised_fit_spec

        return supervised_fit_spec(in_specs, self.label)

    def fit(self, data, labels) -> LinearMapper:
        record_dispatch()  # one batched call (JAX :248)
        X, Y = data.gather(), labels.gather()
        W, info = dual_solve(X, Y, torch.ones(X.shape[0], dtype=torch.bool,
                                              device=X.device), self.lam)
        raise_if_unfactored(info, "the dual system XXᵀ + λI")
        return LinearMapper(W)
