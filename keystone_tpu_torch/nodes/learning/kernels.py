"""Kernel methods: RBF kernel blocks, kernel ridge regression by
Gauss-Seidel block coordinate descent, and the blocked kernel model
apply.

Counterpart of `keystone_tpu/nodes/learning/kernels.py` (reference
nodes/learning/KernelGenerator.scala:18-206, KernelMatrix.scala:17-90,
KernelRidgeRegression.scala:37-275, KernelBlockLinearMapper.scala:28-90).
The n×n kernel never materializes: each block step computes one (n, B)
column block K(X, Xb) = exp(−γ‖x − y‖²) with the RBF kernel
(`ops/kernels.py::rbf_block`; JAX `_rbf_block`, `kernels.py:33-52`), solves
the (B, B) system by Cholesky and updates the dual model. Everything is
float32; the products outside the kernel (`Kb @ delta`, the apply's
`Kb @ alpha_b`) are torch matmuls in true fp32 (TF32 off, `device.py`),
as JAX leaves them to XLA at ``Precision.HIGHEST``.

On a mesh's data axis (JAX fits the same code on a row-sharded
``Dataset`` and GSPMD moves the rows) the fit and the apply keep every
row-sized array on its rank and gather only a block's rows by their
global ids (`parallel.gather_rows`), so K5 runs on each rank's rows and
the blocks, the solves and alpha are one process's.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...ops.kernels import rbf_block
from ...parallel.collectives import collect_rows, gather_rows
from ...parallel.mesh import DATA_AXIS, axis_size, data_rank
from ...telemetry.instrument import record_dispatch
from ...telemetry.metrics import counter
from ...telemetry.spans import span
from ...workflow.pipeline import Estimator, LabelEstimator, Transformer

_STEPS = counter("solver.steps")


class GaussianKernelTransformer(Transformer):
    """x → K(x, anchors) (KernelGenerator.scala)."""

    def __init__(self, anchors: torch.Tensor, gamma: float):
        self.anchors = anchors
        self.gamma = gamma

    def batch_fn(self):
        return lambda x: rbf_block(x.contiguous(), self.anchors, self.gamma)


class GaussianKernelGenerator(Estimator):
    """Fits a `GaussianKernelTransformer` anchored at the data's rows: on
    a mesh's data axis every rank's valid rows, in global order
    (`parallel.collect_rows`), as JAX's ``data.array[:data.count]`` of a
    global array (`kernels.py:78-83`). The transformer then runs K5 on
    each rank's rows against them."""

    mesh_aware = True  # the anchors collected over the data axis

    def __init__(self, gamma: float):
        self.gamma = gamma

    def fit(self, data) -> GaussianKernelTransformer:
        rows = data.array[:int(data.mask.sum())] if data.has_padding \
            else data.array
        return GaussianKernelTransformer(
            collect_rows(rows, _data_mesh(data.mesh)), self.gamma)


class BlockKernelMatrix:
    """Lazy column-block view of K(X, X) with optional block caching
    (KernelMatrix.scala:17-90)."""

    def __init__(self, X: torch.Tensor, gamma: float,
                 cache_blocks: bool = False):
        self.X = X
        self.gamma = float(gamma)
        self.cache_blocks = cache_blocks
        self._cache = {}

    def block(self, idx: int, block_size: int) -> torch.Tensor:
        key = (int(idx), block_size)
        if key in self._cache:
            return self._cache[key]
        start = int(idx) * block_size
        Kb = rbf_block(self.X, self.X[start:start + block_size], self.gamma)
        if self.cache_blocks:
            self._cache[key] = Kb
        return Kb


def _data_mesh(mesh):
    """``mesh`` where its data axis has more than one rank, else None."""
    return mesh if axis_size(mesh, DATA_AXIS) > 1 else None


def _block_delta(Kbb, Yb, KAb, ab, lam: float) -> torch.Tensor:
    """Δ of (K_bb + λI) Δ = Y_b − KA_b − λ α_b."""
    A = Kbb + lam * torch.eye(Kbb.shape[0], dtype=Kbb.dtype,
                              device=Kbb.device)
    return torch.cholesky_solve(Yb - KAb - lam * ab, torch.linalg.cholesky(A))


def krr_step(mesh, X, Y, mask, alpha, KA, lam: float, gamma: float,
             block_ids) -> None:
    """One Gauss-Seidel block update of dual KRR (K + λI)α = Y
    (`kernels.py:107-139`). KA tracks K @ alpha. For block b, solve
    (K_bb + λI) Δ = Y_b − KA_b − λ α_b, then α_b += Δ, KA += K[:, b] Δ.

    X, Y, ``mask``, alpha and KA are this rank's rows of ``mesh``'s data
    axis (all of them without a mesh) and ``block_ids`` global row ids.
    The block's rows of X are gathered (`parallel.gather_rows`), K5
    computes this rank's rows of Kb, the block's rows of Kb, Y, KA and
    alpha are gathered by the same ids, every rank solves the same
    system, and the updates touch only this rank's rows. ``alpha`` and
    ``KA`` are updated in place, where JAX donates their buffers to the
    step. The last block of an epoch repeats ids; their updates add up,
    as JAX's ``alpha.at[ids].add`` adds them (`index_add_`; an indexed
    ``+=`` would keep only one)."""
    block_ids = np.asarray(block_ids, dtype=np.int64)
    Kb = rbf_block(X, gather_rows(X, block_ids, mesh), gamma)
    Kb.mul_(mask[:, None])                       # this rank's rows
    Yb, KAb, ab = gather_rows(torch.cat([Y, KA, alpha], dim=1), block_ids,
                              mesh).split(Y.shape[1], dim=1)
    delta = _block_delta(gather_rows(Kb, block_ids, mesh), Yb, KAb, ab, lam)
    lo = data_rank(mesh) * X.shape[0]
    own = np.nonzero((block_ids >= lo) & (block_ids < lo + X.shape[0]))[0]
    alpha.index_add_(
        0, torch.as_tensor(block_ids[own] - lo, device=X.device),
        delta[torch.as_tensor(own, device=X.device)])
    KA.addmm_(Kb, delta)


class KernelBlockLinearMapper(Transformer):
    """Apply a kernel model block by block, accumulating K(x, train_b) @
    alpha_b over the train blocks (KernelBlockLinearMapper.scala:28-90;
    JAX `_kernel_apply_scan`, `kernels.py:142-208`). The last train
    block is zero-padded to the block size: its padded anchors have
    alpha 0 and add nothing.

    Fitted on a mesh (``mesh``), ``train_X`` and ``alpha`` are this
    rank's rows of the ``count`` training rows: each apply block's
    anchors and alpha are gathered over ``data`` as it is used (the
    blocks one process uses), and K5 runs on this rank's test rows
    against it; the whole training matrix is never gathered."""

    precision_tolerance = "exact"  # kernel solve apply: f32 inputs

    def __init__(self, train_X: torch.Tensor, alpha: torch.Tensor,
                 gamma: float, block_size: int = 4096, mesh=None,
                 count: Optional[int] = None):
        self.train_X = train_X
        self.alpha = alpha
        self.gamma = gamma
        self.block_size = block_size
        self.mesh = _data_mesh(mesh)
        self.count = train_X.shape[0] if count is None else int(count)

    def abstract_apply(self, elem):
        """The output element (JAX `kernels.py:173-182`), declared so
        that tracing a spec runs no block (on a mesh, no gather)."""
        from ...analysis.specs import SpecMismatchError, shape_struct

        d = self.train_X.shape[1]
        if getattr(elem, "ndim", None) == 1 and elem.shape[0] != d:
            raise SpecMismatchError(
                f"kernel model was trained on {d}-dim features but the "
                f"input element has {elem.shape[0]}")
        return shape_struct((self.alpha.shape[1],), self.alpha.dtype)

    def _block(self, start: int, stop: int):
        """Anchors and alpha of training rows ``start:stop``."""
        ids = np.arange(start, stop)
        return (gather_rows(self.train_X, ids, self.mesh),
                gather_rows(self.alpha, ids, self.mesh))

    def batch_fn(self):
        def fn(x):
            x = x.contiguous()
            n_train = self.count
            bs = min(self.block_size, n_train)
            out = torch.zeros((x.shape[0], self.alpha.shape[1]),
                              dtype=x.dtype, device=x.device)
            for start in range(0, n_train, bs):
                Xb, ab = self._block(start, min(start + bs, n_train))
                if Xb.shape[0] < bs:
                    Xb = F.pad(Xb, (0, 0, 0, bs - Xb.shape[0]))
                    ab = F.pad(ab, (0, 0, 0, bs - ab.shape[0]))
                out.addmm_(rbf_block(x, Xb, self.gamma), ab)
            return out

        return fn


class KernelRidgeRegression(LabelEstimator):
    """Dual KRR by Gauss-Seidel BCD over permuted sample blocks
    (KernelRidgeRegression.scala:37-275; `kernels.py:211-337`).

    Each epoch visits the blocks of a permutation drawn from numpy's
    ``default_rng(seed + epoch)``, as the JAX package does, so both
    packages visit the same blocks in the same order. With
    ``checkpoint_dir``, the solver state (alpha, KA, epoch, block) is
    saved every ``blocks_before_checkpoint`` blocks to an ``.npz`` named
    after a fingerprint of the data, restored by a later fit on the same
    data, and deleted when the fit completes."""

    precision_tolerance = "exact"  # solver: f32/HIGHEST inputs
    mesh_aware = True  # K5 on each rank's rows, the block gathered

    def __init__(self, gamma: float, lam: float, block_size: int = 2048,
                 num_epochs: int = 1, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 blocks_before_checkpoint: int = 25):
        self.gamma = gamma
        self.lam = lam
        self.block_size = block_size
        self.num_epochs = num_epochs
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.blocks_before_checkpoint = blocks_before_checkpoint

    def abstract_fit(self, in_specs):
        from ...analysis.specs import supervised_fit_spec

        return supervised_fit_spec(in_specs, self.label)

    def abstract_sharding(self, in_shardings, in_specs):
        """The kernel blocks are computed against row-sharded training
        data (JAX `kernels.py:238-245`): both training inputs must
        arrive data-sharded, or the dual solve reshards the whole
        training set (KP601). Static: the planner reads it."""
        from ...analysis.sharding import fit_sharding_demands

        return fit_sharding_demands(2)

    @property
    def weight(self) -> int:
        """Passes over the features (`workflow/autocache.py::node_weight`)."""
        return 3 * self.num_epochs + 1

    def _ckpt_path(self, data, labels) -> Optional[str]:
        """The checkpoint file for this fit (`kernels.py:251-282`): the
        data's first rows, count and shape are fingerprinted, so a
        checkpoint of other data with the same shape never resumes."""
        if not self.checkpoint_dir:
            return None
        if dist.is_initialized() and dist.get_world_size() > 1:
            # one process's file: every rank would race it, and the
            # state is each rank's rows (JAX `kernels.py:260-270`)
            logging.getLogger(__name__).warning(
                "KernelRidgeRegression checkpointing is single-process "
                "only; disabling for this %d-process job",
                dist.get_world_size())
            return None
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        h = hashlib.sha1()
        h.update(np.asarray(data.take(4)).tobytes())
        h.update(np.asarray(labels.take(4)).tobytes())
        h.update(str((data.count, tuple(data.array.shape))).encode())
        tag = (f"krr_{h.hexdigest()[:12]}_B{self.block_size}"
               f"_g{self.gamma}_l{self.lam}_s{self.seed}")
        return os.path.join(self.checkpoint_dir, tag + ".npz")

    def fit(self, data, labels) -> KernelBlockLinearMapper:
        """On a mesh (data placed over more than one rank) X, Y, alpha
        and KA stay this rank's rows and each block step gathers the
        block (`krr_step`); the blocks are one process's."""
        mesh = _data_mesh(getattr(data, "mesh", None))
        X = data.array.contiguous()
        mask = data.mask.to(X.dtype)
        Y = labels.array.to(X.dtype) * mask[:, None]
        B = min(self.block_size, data.count)
        n_blocks = -(-data.count // B)
        alpha = torch.zeros((X.shape[0], Y.shape[1]), dtype=X.dtype,
                            device=X.device)
        KA = torch.zeros_like(alpha)
        start_epoch, start_block = 0, 0
        ckpt = self._ckpt_path(data, labels)
        if ckpt and os.path.exists(ckpt):
            state = np.load(ckpt)
            alpha.copy_(torch.from_numpy(state["alpha"]))
            KA.copy_(torch.from_numpy(state["KA"]))
            start_epoch, start_block = int(state["epoch"]), int(state["block"])
        done = 0
        for epoch in range(start_epoch, self.num_epochs):
            perm = np.random.default_rng(self.seed + epoch).permutation(
                data.count)
            pad = (-len(perm)) % (n_blocks * B)
            ids = np.concatenate([perm, perm[:pad]]) if pad else perm
            first = start_block if epoch == start_epoch else 0
            for b in range(first, n_blocks):
                with span("krr_step", cat="step", epoch=epoch, block=b):
                    krr_step(mesh, X, Y, mask, alpha, KA, self.lam,
                             self.gamma, ids[b * B:(b + 1) * B])
                _STEPS.inc()
                record_dispatch()
                done += 1
                if ckpt and done % self.blocks_before_checkpoint == 0:
                    # written whole, then renamed: a crash mid-save
                    # leaves the previous checkpoint intact
                    tmp = ckpt + ".tmp.npz"
                    np.savez(tmp, alpha=alpha.cpu().numpy(),
                             KA=KA.cpu().numpy(), epoch=epoch, block=b + 1)
                    os.replace(tmp, ckpt)
        if ckpt and os.path.exists(ckpt):
            os.unlink(ckpt)
        return KernelBlockLinearMapper(X, alpha, self.gamma, self.block_size,
                                       mesh=mesh, count=data.count)
