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

On a mesh (`parallel/`), as JAX's `_bcd_prepare` and `block_step`
(`:55-135`) do under GSPMD: the rows are masked, the centring sums are
all-reduced over ``data`` and divided by the global count, each block's
``XᵀX`` and ``XᵀR`` are all-reduced in one call while the residual stays
on its rank, and every rank factors the same sums, so every rank holds
the same bits of W and b.

On a ``(data, model)`` mesh (JAX's ``x_sharding``, `:41-135`, fit
`:316-360`) the features are this rank's column tile: the centring sums
are the tile's, reduced over ``data``, and each block's columns meet by
one all-reduce over ``model`` of a zeroed (rows, block) buffer that
holds this rank's part of the block (`parallel/collectives.py::
gather_block`), a block at a time and epoch, as GSPMD moves a block
slice of a ``P("data", "model")`` matrix. A block's Gram has cross terms
between the shards' columns, so the block itself has to meet: each rank
of a model group then holds the same block and residual, and runs the
data-axis step above. The intercept's ``x̄·W`` is a partial product over
the tile's columns, all-reduced over ``model``. `BlockLinearMapper`
applies to a tile the same way: ``x_tile·W[tile rows]`` all-reduced over
``model``, plus b.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...parallel.collectives import all_reduce, gather_block, psum
from ...parallel.mesh import MODEL_AXIS
from ...telemetry.instrument import record_dispatch
from ...telemetry.metrics import counter
from ...telemetry.spans import span
from ...workflow.pipeline import LabelEstimator, Transformer

_STEPS = counter("solver.steps")


def bcd_fit(x: torch.Tensor, y: torch.Tensor, lam: float, block_size: int,
            num_iter: int, center: bool = True,
            on_epoch: Optional[Callable[[int], None]] = None,
            mask: Optional[torch.Tensor] = None, mesh=None,
            count: Optional[int] = None, model_mesh=None,
            col_start: int = 0, width: Optional[int] = None):
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
    spans time what the host queued. With ``mesh``, ``x`` and ``y`` are
    this rank's rows, ``mask`` (None: all valid) its valid ones and
    ``count`` the global row count. With ``model_mesh``, ``x`` is this
    rank's columns ``col_start:`` of a matrix ``width`` columns wide (a
    multiple of ``block_size``; columns no rank holds are zero), each
    block gathered over ``model`` where it is used."""
    record_dispatch()  # the prepare
    n, d = x.shape
    if model_mesh is not None:
        d = width
    k = y.shape[1]
    m = None if mask is None else mask.to(x.dtype)[:, None]
    if m is not None:
        x, y = x * m, y * m
    if mesh is not None:
        n = count
    if center:
        if mesh is None:
            xm = x.sum(dim=0) / n
            ym = y.sum(dim=0) / n
        else:
            xm, ym = (v / n for v in psum((x.sum(dim=0), y.sum(dim=0)),
                                          mesh))
        xc, r = x - xm, y - ym
        if m is not None:
            xc, r = xc.mul_(m), r.mul_(m)
    else:
        xm = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
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
                lo, hi = b * block_size, (b + 1) * block_size
                xb = (xc[:, lo:hi] if model_mesh is None
                      else gather_block(xc, col_start, lo, hi, model_mesh))
                r = r + xb @ w[b]
                if mesh is None:
                    gram, rhs = xb.T @ xb + eye, xb.T @ r
                else:  # all-reduced over the data axis
                    gram, rhs = psum((xb.T @ xb, xb.T @ r), mesh)
                    gram = gram + eye
                chol, failed = torch.linalg.cholesky_ex(gram)
                info = torch.maximum(info, failed)
                w[b] = torch.cholesky_solve(rhs, chol)
                r = r - xb @ w[b]
        _STEPS.inc()
        record_dispatch()
        if on_epoch is not None:
            on_epoch(epoch)
    record_dispatch()  # the finalize
    w_full = w.reshape(d, k)
    if model_mesh is None:
        return w_full, ym - xm @ w_full, info
    xw = all_reduce(xm @ w_full[col_start:col_start + x.shape[1]],
                    model_mesh, MODEL_AXIS)
    return w_full, ym - xw, info


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


def apply_on_tile(data, W: torch.Tensor, b: Optional[torch.Tensor]):
    """x·W (+ b) of a dataset held as a column tile: the tile times W's
    rows of its columns, all-reduced over ``model`` (the partial ``X·W``
    GSPMD reduces), the whole (rows, k) result then placed as `Dataset`
    places a stage's output. One dispatch."""
    record_dispatch()
    lo, w = data.col_start, data.array.shape[1]
    out = all_reduce(data.array @ W[lo:lo + w], data.model_mesh, MODEL_AXIS)
    if b is not None:
        out = out + b
    return data.with_data(out, cols="auto")


class BlockLinearMapper(Transformer):
    """x ↦ x W + b; inputs narrower than W are zero-padded, as the fit
    padded them (BlockLinearMapper.scala:22-137)."""

    precision_tolerance = "exact"  # solver apply: f32/HIGHEST inputs

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    model_aware = True  # a tile's partial product, all-reduced over model

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

    def apply_batch(self, data):
        if getattr(data, "tiled", False):
            return apply_on_tile(data, self.W, self.b)
        return super().apply_batch(data)

    def fuse(self):
        return ("BlockLinearMapper", int(self.W.shape[0])), (self.W, self.b)


class BlockLeastSquaresEstimator(LabelEstimator):
    """BCD least squares with L2 (BlockLinearMapper.scala:199-283)."""

    precision_tolerance = "exact"

    fusable_fit = True

    mesh_aware = True  # Grams all-reduced over the data axis

    model_aware = True  # blocks gathered over the model axis as they are used

    def __init__(self, block_size: int, num_iter: int, lam: float = 0.0,
                 fit_intercept: bool = True):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.fit_intercept = fit_intercept
        #: passes over the features (`workflow/autocache.py::node_weight`)
        self.weight = 3 * num_iter + 1

    def abstract_fit(self, in_specs):
        """Static fit (`keystone_tpu/nodes/learning/block_ls.py:
        302-314`): (d,) features + (k,) labels → a model mapping (d,) to
        (k,); the solver zero-pads features to a block multiple, so apply
        accepts any dim ≤ ceil(d/bs)·bs."""
        from ...analysis.specs import leaf_vector_dim, supervised_fit_spec

        d = leaf_vector_dim(in_specs[0] if in_specs else None)
        d_pad = None
        if d is not None:
            bs = min(self.block_size, d)
            d_pad = -(-d // bs) * bs
        return supervised_fit_spec(in_specs, self.label, max_in_dim=d_pad)

    def abstract_sharding(self, in_shardings, in_specs):
        """The sweep's per-block Grams are partial sums over this rank's
        rows all-reduced over ``data`` (JAX `:316-323`): both training
        inputs must arrive row-sharded, or the fit reshards its whole
        training set (KP601)."""
        from ...analysis.sharding import fit_sharding_demands

        return fit_sharding_demands(2)

    def fit(self, data, labels) -> BlockLinearMapper:
        labels = labels.gather_model() if labels.tiled else labels
        x, y = data.array, labels.array.to(data.array.dtype)
        d = data.width
        bs = min(self.block_size, d)
        d_pad = -(-d // bs) * bs
        tile = {}
        if data.tiled:
            tile = dict(model_mesh=data.model_mesh,
                        col_start=data.col_start, width=d_pad)
        elif d_pad != d:
            x = F.pad(x, (0, d_pad - d))
        w, b, info = bcd_fit(x, y, self.lam, bs, self.num_iter,
                             self.fit_intercept,
                             mask=data.mask if data.has_padding else None,
                             mesh=data.mesh, count=data.count, **tile)
        raise_if_unfactored(info)
        return BlockLinearMapper(w, b if self.fit_intercept else None)
