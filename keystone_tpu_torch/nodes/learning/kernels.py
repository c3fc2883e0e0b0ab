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
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.kernels import rbf_block
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
    """Fits a `GaussianKernelTransformer` anchored at the data's rows."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def fit(self, data) -> GaussianKernelTransformer:
        return GaussianKernelTransformer(data.array[:data.count], self.gamma)


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


def krr_step(X, Y, mask, alpha, KA, lam: float, gamma: float,
             block_ids: torch.Tensor) -> None:
    """One Gauss-Seidel block update of dual KRR (K + λI)α = Y
    (`kernels.py:107-139`). KA tracks K @ alpha. For block b, solve
    (K_bb + λI) Δ = Y_b − KA_b − λ α_b, then α_b += Δ, KA += K[:, b] Δ.

    ``alpha`` and ``KA`` are updated in place, where JAX donates their
    buffers to the step. The last block of an epoch repeats ids; their
    updates add up, as JAX's ``alpha.at[ids].add`` adds them
    (`index_add_`; an indexed ``+=`` would keep only one)."""
    B = block_ids.shape[0]
    Kb = rbf_block(X, X[block_ids], gamma)
    Kb.mul_(mask[:, None])                       # (n, B), masked rows
    Kbb = Kb[block_ids]                          # (B, B)
    resid = Y[block_ids] - KA[block_ids] - lam * alpha[block_ids]
    A = Kbb + lam * torch.eye(B, dtype=X.dtype, device=X.device)
    delta = torch.cholesky_solve(resid, torch.linalg.cholesky(A))
    alpha.index_add_(0, block_ids, delta)
    KA.addmm_(Kb, delta)


class KernelBlockLinearMapper(Transformer):
    """Apply a kernel model block by block, accumulating K(x, train_b) @
    alpha_b over the train blocks (KernelBlockLinearMapper.scala:28-90;
    JAX `_kernel_apply_scan`, `kernels.py:142-208`). The last train
    block is zero-padded to the block size: its padded anchors have
    alpha 0 and add nothing."""

    precision_tolerance = "exact"  # kernel solve apply: f32 inputs

    def __init__(self, train_X: torch.Tensor, alpha: torch.Tensor,
                 gamma: float, block_size: int = 4096):
        self.train_X = train_X
        self.alpha = alpha
        self.gamma = gamma
        self.block_size = block_size

    def batch_fn(self):
        def fn(x):
            x = x.contiguous()
            n_train = self.train_X.shape[0]
            bs = min(self.block_size, n_train)
            out = torch.zeros((x.shape[0], self.alpha.shape[1]),
                              dtype=x.dtype, device=x.device)
            for start in range(0, n_train, bs):
                Xb = self.train_X[start:start + bs]
                ab = self.alpha[start:start + bs]
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
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        h = hashlib.sha1()
        h.update(np.asarray(data.take(4)).tobytes())
        h.update(np.asarray(labels.take(4)).tobytes())
        h.update(str((data.count, tuple(data.array.shape))).encode())
        tag = (f"krr_{h.hexdigest()[:12]}_B{self.block_size}"
               f"_g{self.gamma}_l{self.lam}_s{self.seed}")
        return os.path.join(self.checkpoint_dir, tag + ".npz")

    def fit(self, data, labels) -> KernelBlockLinearMapper:
        X = data.array.contiguous()
        mask = data.mask.to(X.dtype)
        Y = labels.array.to(X.dtype) * mask[:, None]
        n_pad = X.shape[0]
        B = min(self.block_size, n_pad)
        n_blocks = -(-data.count // B)
        alpha = torch.zeros((n_pad, Y.shape[1]), dtype=X.dtype,
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
            ids = torch.as_tensor(ids, dtype=torch.int64, device=X.device)
            first = start_block if epoch == start_epoch else 0
            for b in range(first, n_blocks):
                with span("krr_step", cat="step", epoch=epoch, block=b):
                    krr_step(X, Y, mask, alpha, KA, self.lam, self.gamma,
                             ids[b * B:(b + 1) * B])
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
        return KernelBlockLinearMapper(X, alpha, self.gamma, self.block_size)
