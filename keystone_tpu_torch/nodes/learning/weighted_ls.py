"""Class-weighted least squares by block coordinate descent.

Counterpart of `keystone_tpu/nodes/learning/weighted_ls.py` (`:31-135`;
reference nodes/learning/BlockWeightedLeastSquares.scala:36-371,
PerClassWeightedLeastSquares.scala:31-223). For class c every example
gets the weight

    w_c(i) = mw·member_c(i)/n_c + (1 − mw)·mask(i)/count,

so each class's column of W solves its own weighted ridge problem, the
features centred by the class's weighted mean. JAX forms the k weighted
Grams with one einsum over (k, n, B) weighted copies of each block
(`:65-66`). Here the weight splits the Gram instead:

    Xᵀ diag(w_c) X = (1 − mw)/count · XᵀX + mw/n_c · X_cᵀ X_c,

one shared Gram over the rows plus one over class c's rows alone, so a
block costs about 1 + (labels a row) Grams of work instead of k, and no
(k, n, B) copy exists. The class rows are read from the labels once a
fit (the fit's host syncs). Each class's system is factored on its own
(`cholesky_ex`, one B × B matrix alive at a time), the infos checked
once a fit (`block_ls.raise_if_unfactored`). Everything runs in true
float32, as JAX pins ``HIGHEST``. On a mesh's data axis the sums, the
shared Gram, the correlations and each class's Gram are all-reduced a
block, and every rank factors the same systems.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel.collectives import psum
from ...parallel.mesh import DATA_AXIS, axis_size
from ...workflow.pipeline import LabelEstimator
from .block_ls import raise_if_unfactored
from .linear import LinearMapper


def bwls_fit(X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
             lam: float, mixture_weight: float, block_size: int,
             num_iter: int, mesh=None):
    """(W, b, info) of the class-weighted BCD (`_bwls_fit`, `:31-101`).
    X (n, d) with d a multiple of ``block_size``; Y (n, k) the ±1
    indicators; ``mask`` (n,) the valid rows. ``info`` is nonzero where a
    class's system was not positive definite.

    On ``mesh`` X, Y and ``mask`` are this rank's rows (none of them
    need be valid): the class sizes and the valid count, then the
    weighted sums behind the means, and in each block the shared Gram,
    the correlations and each class's Gram of its rows are all-reduced
    over ``data`` (GSPMD's psum at JAX's einsums over the sharded rows),
    and every rank solves every class's system."""
    n, d = X.shape
    k = Y.shape[1]
    dtype, dev = X.dtype, X.device
    mask = mask.to(dtype)
    member = (Y > 0).to(dtype) * mask[:, None]                  # (n, k)
    count, n_c = psum((mask.sum(), member.sum(dim=0)), mesh)
    n_c = torch.clamp(n_c, min=1.0)
    a = mixture_weight / n_c                                    # (k,)
    beta = (1.0 - mixture_weight) / count
    Wts = a * member + beta * mask[:, None]                     # (n, k)
    wsum, wx, wy = psum((Wts.sum(dim=0), Wts.T @ X,
                         (Wts * Y).sum(dim=0)), mesh)
    xbar = wx / wsum[:, None]                                   # (k, d)
    ybar = wy / wsum
    # the rows of each class held here and the classes' sizes, read
    # once a fit
    cls, rows = member.T.nonzero(as_tuple=True)
    counts = torch.bincount(cls, minlength=k).tolist()
    class_rows = torch.split(rows, counts)
    a_host = [mixture_weight / max(m, 1.0) for m in n_c.tolist()]
    Xm = X * mask[:, None]

    num_blocks = d // block_size
    W = torch.zeros((num_blocks, block_size, k), dtype=dtype, device=dev)
    R = (Y - ybar) * mask[:, None]
    eye = lam * torch.eye(block_size, dtype=dtype, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(num_iter):
        for blk in range(num_blocks):
            sl = slice(blk * block_size, (blk + 1) * block_size)
            Xb, xb = X[:, sl], xbar[:, sl]
            R1 = R + Xb @ W[blk]
            WR = Wts * R1
            shared, XWR, wr = psum((Xm[:, sl].T @ Xb, Xb.T @ WR,
                                    WR.sum(dim=0)), mesh)
            shared = beta * shared + eye
            C = XWR - xb.T * wr                                     # (B, k)
            u = wsum[:, None] * xb
            for c in range(k):
                # G_c = a_c·X_cᵀX_c + shared − wsum_c·x̄_c x̄_cᵀ, factored
                # one class at a time: cuSOLVER's single-matrix route
                # (the batched call takes MAGMA's, 1.6× slower at 20 ×
                # 4096², `profile_weighted_ls.py`)
                Xc = Xb.index_select(0, class_rows[c])
                if mesh is None:
                    G = torch.addmm(shared, Xc.T, Xc, alpha=a_host[c])
                else:
                    G = psum(Xc.T @ Xc, mesh).mul_(a_host[c]).add_(shared)
                G.addr_(u[c], xb[c], alpha=-1.0)
                chol, failed = torch.linalg.cholesky_ex(G)
                info = torch.maximum(info, failed)
                W[blk, :, c] = torch.cholesky_solve(C[:, c:c + 1], chol)[:, 0]
            R = R1 - Xb @ W[blk]
    W_full = W.reshape(d, k)
    b = ybar - (xbar * W_full.T).sum(dim=1)
    return W_full, b, info


class BlockWeightedLeastSquaresEstimator(LabelEstimator):
    """Class-weighted BCD (BlockWeightedLeastSquares.scala:36-371): the
    features zero-padded to a multiple of the block, which is at most
    their width. On a mesh the weighted sums and Grams are all-reduced
    over ``data`` (`bwls_fit`)."""

    mesh_aware = True  # sums and Grams all-reduced over the data axis

    def __init__(self, block_size: int, num_iter: int, lam: float,
                 mixture_weight: float = 0.5):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        #: passes over the features (`workflow/autocache.py::node_weight`)
        self.weight = 3 * num_iter + 1

    def abstract_fit(self, in_specs):
        from ...analysis.specs import supervised_fit_spec

        return supervised_fit_spec(in_specs, self.label)

    def fit(self, data, labels) -> LinearMapper:
        X, Y = data.array, labels.array.to(data.array.dtype)
        d = X.shape[1]
        bs = min(self.block_size, d)
        d_pad = -(-d // bs) * bs
        if d_pad != d:
            X = F.pad(X, (0, d_pad - d))
        mesh = getattr(data, "mesh", None)
        W, b, info = bwls_fit(X, Y, data.mask, self.lam, self.mixture_weight,
                              bs, self.num_iter,
                              mesh if axis_size(mesh, DATA_AXIS) > 1 else None)
        raise_if_unfactored(info, "BWLS: a class's weighted ridge Gram "
                                  "matrix")
        return LinearMapper(W[:d], b)


class PerClassWeightedLeastSquares(LabelEstimator):
    """The same weighted normal equations in one block and one sweep
    (PerClassWeightedLeastSquares.scala:31-223)."""

    mesh_aware = True  # as the block solver it runs

    def __init__(self, lam: float, mixture_weight: float = 0.5):
        self.lam = lam
        self.mixture_weight = mixture_weight

    def fit(self, data, labels) -> LinearMapper:
        return BlockWeightedLeastSquaresEstimator(
            data.array.shape[1], 1, self.lam, self.mixture_weight).fit(
                data, labels)
