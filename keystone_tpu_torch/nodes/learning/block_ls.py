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

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...telemetry.instrument import record_dispatch
from ...telemetry.metrics import counter
from ...telemetry.spans import span
from ...workflow.pipeline import LabelEstimator, Transformer

_STEPS = counter("solver.steps")


def bcd_fit(x: torch.Tensor, y: torch.Tensor, lam: float, block_size: int,
            num_iter: int, center: bool = True,
            on_epoch: Optional[Callable[[int], None]] = None):
    """(W, b, info): W, b minimize ‖(x W + b) − y‖² + lam‖W‖² by
    ``num_iter`` sweeps over feature blocks of ``block_size`` columns.
    ``x``'s width must be a multiple of ``block_size``; W has that width.
    ``info`` is a 0-d int32 tensor on x's device, nonzero where a block's
    ridge Gram matrix was not positive definite: the factorizations are
    `cholesky_ex`, which leaves that check on the device, so the fit
    makes no host sync of its own. Check it with `raise_if_unfactored`.
    The residual carries from one epoch into the next; ``on_epoch(i)``,
    where given, is called after epoch ``i`` is enqueued. Each epoch is a
    ``bcd_epoch`` step span and a ``solver.steps`` count (JAX's `:352-364`,
    which also counts the prepare and the finalize as dispatches); the
    spans time what the host queued."""
    record_dispatch()  # the prepare
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
    info = torch.zeros((), dtype=torch.int32, device=x.device)
    for epoch in range(num_iter):
        with span("bcd_epoch", cat="step", iter=epoch, blocks=num_blocks):
            for b in range(num_blocks):
                xb = xc[:, b * block_size:(b + 1) * block_size]
                r = r + xb @ w[b]
                gram = xb.T @ xb + eye
                chol, failed = torch.linalg.cholesky_ex(gram)
                info = torch.maximum(info, failed)
                w[b] = torch.cholesky_solve(xb.T @ r, chol)
                r = r - xb @ w[b]
        _STEPS.inc()
        record_dispatch()
        if on_epoch is not None:
            on_epoch(epoch)
    record_dispatch()  # the finalize
    w_full = w.reshape(d, k)
    return w_full, ym - xm @ w_full, info


def raise_if_unfactored(
        info: torch.Tensor,
        what: str = "BCD: a block's ridge Gram matrix") -> None:
    """Raise where a `cholesky_ex` ``info`` (`bcd_fit`'s by default) says
    ``what`` was not positive definite (reading it waits for the
    device)."""
    if int(info):
        raise torch.linalg.LinAlgError(
            f"{what} is not positive definite (leading minor of order "
            f"{int(info)})")


class BlockLinearMapper(Transformer):
    """x ↦ x W + b; inputs narrower than W are zero-padded, as the fit
    padded them (BlockLinearMapper.scala:22-137)."""

    chunkable = True  # per-item: distributes over chunks

    fusable = True

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

    fusable_fit = True

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 fit_intercept: bool = True):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.fit_intercept = fit_intercept
        #: passes over the features (`workflow/autocache.py::node_weight`)
        self.weight = 3 * num_iter + 1

    def fit(self, data, labels) -> BlockLinearMapper:
        x, y = data.array, labels.array.to(data.array.dtype)
        d = x.shape[1]
        bs = min(self.block_size, d)
        d_pad = -(-d // bs) * bs
        if d_pad != d:
            x = F.pad(x, (0, d_pad - d))
        w, b, info = bcd_fit(x, y, self.lam, bs, self.num_iter,
                             self.fit_intercept)
        raise_if_unfactored(info)
        return BlockLinearMapper(w, b if self.fit_intercept else None)
