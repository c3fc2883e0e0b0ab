"""Numeric helpers on the host.

Counterpart of `keystone_tpu/utils/stats.py` (reference
utils/Stats.scala:12-124 and utils/MatrixUtils.scala:17-205): numpy
functions, as JAX's are; a tensor argument is copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def about_eq(a, b, tol: float = 1e-8) -> bool:
    """Elementwise |a − b| ≤ tol in float64, False on a shape mismatch
    (Stats.aboutEq, utils/Stats.scala:24-75)."""
    a = _host(a).astype(np.float64)
    b = _host(b).astype(np.float64)
    if a.shape != b.shape:
        return False
    return bool(np.all(np.abs(a - b) <= tol))


def normalize_rows(X, floor: float = 2.2e-16) -> np.ndarray:
    """Each row over its L2 norm, the norm floored at ``floor``
    (Stats.normalizeRows, utils/Stats.scala:90-124)."""
    X = _host(X)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(norms, floor)


def rows_to_matrix(rows) -> np.ndarray:
    """Row vectors stacked into a matrix (MatrixUtils.rowsToMatrix)."""
    return np.stack([_host(r) for r in rows])


def matrix_to_rows(M) -> list:
    """A matrix's rows (MatrixUtils.matrixToRowArray)."""
    return [np.asarray(r) for r in _host(M)]
