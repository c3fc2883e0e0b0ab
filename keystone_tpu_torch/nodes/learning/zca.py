"""ZCA whitening.

Counterpart of `keystone_tpu/nodes/learning/zca.py` (reference
nodes/learning/ZCAWhitener.scala:12-77): whitener = V diag((λ+ε)^-½) Vᵀ.
The result does not depend on the sign `eigh` gives each eigenvector.
"""

from __future__ import annotations

import numpy as np
import torch

from ...workflow.pipeline import Transformer


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
