"""ZCA whitening.

Counterpart of `keystone_tpu/nodes/learning/zca.py` (reference
nodes/learning/ZCAWhitener.scala:12-77): whitener = V diag((λ+ε)^-½) Vᵀ.
The result does not depend on the sign `eigh` gives each eigenvector.
`ZCAWhitenerEstimator` (`:73-87`) fits it from a sample matrix on the
sample's device; JAX fits on the host with numpy, on the whole
``data.numpy()`` (`:80-87`): on a mesh's data axis the port collects
every rank's valid rows first (`pca.collect_rows`), so every rank fits
one process's whitener.
"""

from __future__ import annotations

import numpy as np
import torch

from ...workflow.pipeline import Estimator, Transformer
from .pca import collect_rows


def zca_from_covariance(cov: torch.Tensor, eps: float) -> torch.Tensor:
    """Whitening matrix from a D×D covariance, in the covariance's
    dtype (ZCAWhitener.scala:53-60)."""
    lams, v = torch.linalg.eigh(cov)
    scale = 1.0 / torch.sqrt(torch.clamp(lams, min=0.0) + eps)
    return (v * scale) @ v.T


class ZCAWhitener(Transformer):
    """x ↦ (x − means) @ whitener."""

    def __init__(self, whitener, means, device="cuda"):
        def tensor(x):
            if isinstance(x, torch.Tensor):
                return x
            return torch.as_tensor(np.asarray(x), device=device)

        self.whitener = tensor(whitener)  # (D, D)
        self.means = tensor(means)        # (D,)

    def batch_fn(self):
        return lambda x: (x - self.means) @ self.whitener


class ZCAWhitenerEstimator(Estimator):
    """Fit a `ZCAWhitener` on an (m × D) sample matrix: its mean, and the
    whitener of its covariance over m − 1 (ZCAWhitener.scala:53-60)."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs

    mesh_aware = True  # the rows collected over the data axis

    def __init__(self, eps: float = 0.1):
        self.eps = eps

    def fit(self, data) -> ZCAWhitener:
        return self.fit_single(collect_rows(data))

    def fit_single(self, X) -> ZCAWhitener:
        """Fit on an in-memory (m × D) matrix (ZCAWhitener.fitSingle): a
        tensor, or an array put on the CPU."""
        X = torch.as_tensor(X).to(torch.float32)
        n = X.shape[0]
        mu = X.mean(dim=0)
        Xc = X - mu
        cov = (Xc.T @ Xc) / max(n - 1.0, 1.0)
        return ZCAWhitener(zca_from_covariance(cov, self.eps), mu)
