"""Diagonal-covariance Gaussian mixture model.

Counterpart of `keystone_tpu/nodes/learning/gmm.py` (`:24-152`;
reference nodes/learning/GaussianMixtureModel.scala:19-106,
GaussianMixtureModelEstimator.scala:25-203): the posteriors by the
three-GEMM Mahalanobis form and `logsumexp`, and EM from a k-means++ (or
random) start with a variance floor relative to the global variance
(Sanchez et al.), every step a handful of GEMMs in true float32 (TF32
off, `device.py`), as JAX pins ``HIGHEST``. The start's draws are the
JAX package's numpy draws (`kmeans.py::kmeans_pp_init`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...workflow.pipeline import Estimator, Transformer
from .kmeans import kmeans_pp_init


def log_gauss_posteriors(X: torch.Tensor, means: torch.Tensor,
                         variances: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """log p(k | x) of rows X (..., n, d) under diagonal Gaussians
    (k, d): ‖x − m‖²_inv = x²·inv − 2x·(m·inv) + m²·inv
    (GaussianMixtureModel.scala:49-80)."""
    inv = 1.0 / variances
    quad = ((X * X) @ inv.T - 2.0 * X @ (means * inv).T
            + (means * means * inv).sum(dim=1))
    logdet = torch.log(variances).sum(dim=1)
    d = X.shape[-1]
    logp = torch.log(weights) - 0.5 * (quad + logdet
                                       + d * math.log(2.0 * math.pi))
    return logp - torch.logsumexp(logp, dim=-1, keepdim=True)


class GaussianMixtureModel(Transformer):
    """x → its posterior vector, entries below ``posterior_threshold``
    set to 0 (GaussianMixtureModel.scala:19-106). Means and variances
    are (k, d), weights (k,)."""

    def __init__(self, means: torch.Tensor, variances: torch.Tensor,
                 weights: torch.Tensor, posterior_threshold: float = 1e-4):
        self.means = means
        self.variances = variances
        self.weights = weights
        self.posterior_threshold = posterior_threshold

    @property
    def k(self) -> int:
        return self.means.shape[0]

    def posteriors(self, X: torch.Tensor) -> torch.Tensor:
        return torch.exp(log_gauss_posteriors(
            torch.atleast_2d(X), self.means, self.variances, self.weights))

    def batch_fn(self):
        def fn(X):
            q = self.posteriors(X)
            return torch.where(q < self.posterior_threshold, 0.0, q)

        return fn

    @staticmethod
    def load_csv(means_path, variances_path, weights_path,
                 device: DeviceLike = "cuda") -> "GaussianMixtureModel":
        """Sideband CSVs (GaussianMixtureModel.scala:97-105), whose layout
        is dims × clusters: means and variances transpose on load."""
        dev = resolve_device(device)

        def load(path, transpose=True):
            a = np.loadtxt(path, delimiter=",", ndmin=2 if transpose else 1)
            return torch.tensor(a.T if transpose else a, dtype=torch.float32,
                                device=dev)

        return GaussianMixtureModel(load(means_path), load(variances_path),
                                    load(weights_path, transpose=False))


def em(X: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
       weights: torch.Tensor, num_iters: int, min_variance: torch.Tensor):
    """``num_iters`` EM steps: (means, variances, weights)."""
    n = X.shape[0]
    X2 = X * X
    for _ in range(num_iters):
        q = torch.exp(log_gauss_posteriors(X, means, variances, weights))
        nk = q.sum(dim=0)
        safe_nk = torch.clamp(nk, min=1e-8)[:, None]
        means_new = (q.T @ X) / safe_nk
        ex2 = (q.T @ X2) / safe_nk
        variances = torch.maximum(ex2 - means_new ** 2, min_variance)
        means = means_new
        weights = torch.clamp(nk / n, min=1e-10)
        weights = weights / weights.sum()
    return means, variances, weights


class GaussianMixtureModelEstimator(Estimator):
    """EM with a k-means++ (or random) start and a variance floor of
    ``min_variance_factor`` times the global variance, on at most
    ``max_rows`` rows (GaussianMixtureModelEstimator.scala:25-203). On
    a mesh every rank runs k-means++ and EM on the rows one process
    collects (`pca.collect_rows`; JAX `gmm.py:134-152`), so every rank
    fits one process's model."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs
    mesh_aware = True  # the rows collected over the data axis

    def __init__(self, k: int, num_iters: int = 30, init: str = "kmeans++",
                 min_variance_factor: float = 0.01, seed: int = 0,
                 max_rows: int = 200_000):
        if init not in ("kmeans++", "random"):
            raise ValueError("init must be 'kmeans++' or 'random'")
        self.k = k
        self.num_iters = num_iters
        self.init = init
        self.min_variance_factor = min_variance_factor
        self.seed = seed
        self.max_rows = max_rows

    def fit(self, data) -> GaussianMixtureModel:
        from .pca import collect_rows

        X = collect_rows(data, self.max_rows)
        rng = np.random.default_rng(self.seed)
        if self.init == "kmeans++":
            means0 = kmeans_pp_init(X, self.k, rng)
        else:
            pick = rng.choice(X.shape[0], self.k, replace=False)
            means0 = X[torch.as_tensor(pick, device=X.device)]
        global_var = X.var(dim=0, unbiased=False) + 1e-6
        variances0 = global_var.expand(self.k, -1).contiguous()
        weights0 = torch.full((self.k,), 1.0 / self.k, dtype=X.dtype,
                              device=X.device)
        means, variances, weights = em(
            X, means0, variances0, weights0, self.num_iters,
            self.min_variance_factor * global_var)
        return GaussianMixtureModel(means, variances, weights)
