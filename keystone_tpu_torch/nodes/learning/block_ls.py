"""Block coordinate descent least squares.

Counterpart of `keystone_tpu/nodes/learning/block_ls.py` (the prepare →
epoch → finalize arithmetic of `_bcd_fit_impl`, `:55-104`, and the
estimator's padding, `:325-365`; reference
nodes/learning/BlockLinearMapper.scala:22-283). The features are
centred once; each epoch sweeps the feature blocks, adding a block's
contribution back into the residual and re-solving it exactly with a
Cholesky factorization of its ridge Gram matrix. Everything runs in true
float32 (TF32 off, see `device.py`), as the JAX package pins
``Precision.HIGHEST`` here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...workflow.pipeline import LabelEstimator, Transformer


def bcd_fit(x: torch.Tensor, y: torch.Tensor, lam: float, block_size: int,
            num_iter: int, center: bool = True):
    """(W, b) minimizing ‖(x W + b) − y‖² + lam‖W‖² by ``num_iter``
    sweeps over feature blocks of ``block_size`` columns. ``x``'s width
    must be a multiple of ``block_size``; W has that width."""
    n, d = x.shape
    k = y.shape[1]
    if center:
        xm = x.sum(dim=0) / n
        ym = y.sum(dim=0) / n
        xc, r = x - xm, y - ym
    else:
        xm = torch.zeros(d, dtype=x.dtype, device=x.device)
        ym = torch.zeros(k, dtype=y.dtype, device=y.device)
        xc, r = x, y.clone()
    num_blocks = d // block_size
    w = torch.zeros((num_blocks, block_size, k), dtype=x.dtype,
                    device=x.device)
    eye = lam * torch.eye(block_size, dtype=x.dtype, device=x.device)
    for _ in range(num_iter):
        for b in range(num_blocks):
            xb = xc[:, b * block_size:(b + 1) * block_size]
            r = r + xb @ w[b]
            gram = xb.T @ xb + eye
            chol = torch.linalg.cholesky(gram)
            w[b] = torch.cholesky_solve(xb.T @ r, chol)
            r = r - xb @ w[b]
    w_full = w.reshape(d, k)
    return w_full, ym - xm @ w_full


class BlockLinearMapper(Transformer):
    """x ↦ x W + b; inputs narrower than W are zero-padded, as the fit
    padded them (BlockLinearMapper.scala:22-137)."""

    def __init__(self, W: torch.Tensor, b: Optional[torch.Tensor] = None):
        self.W = W
        self.b = b if b is not None else torch.zeros(
            W.shape[1], dtype=W.dtype, device=W.device)

    def batch_fn(self):
        d = self.W.shape[0]

        def fn(x):
            if x.shape[1] < d:
                x = F.pad(x, (0, d - x.shape[1]))
            return x @ self.W + self.b

        return fn


class BlockLeastSquaresEstimator(LabelEstimator):
    """BCD least squares with L2 (BlockLinearMapper.scala:199-283)."""

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 fit_intercept: bool = True):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.fit_intercept = fit_intercept

    def fit(self, data, labels) -> BlockLinearMapper:
        x, y = data.array, labels.array.to(data.array.dtype)
        d = x.shape[1]
        bs = min(self.block_size, d)
        d_pad = -(-d // bs) * bs
        if d_pad != d:
            x = F.pad(x, (0, d_pad - d))
        w, b = bcd_fit(x, y, self.lam, bs, self.num_iter, self.fit_intercept)
        return BlockLinearMapper(w, b if self.fit_intercept else None)
