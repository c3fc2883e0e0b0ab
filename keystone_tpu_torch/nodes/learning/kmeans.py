"""K-means++.

Counterpart of `keystone_tpu/nodes/learning/kmeans.py` (`:22-108`;
reference nodes/learning/KMeansPlusPlus.scala:16-181): k-means++ seeding,
Lloyd's iterations as a loop of torch ops (the GEMM distance trick for
the assignment, a one-hot GEMM for the centroid sums), and the
assignment transformer.

`kmeans_pp_init` draws what the JAX package's host seeding draws from
the same numpy generator, without a host round trip a step: numpy's
``rng.choice(n, p=p)`` is one ``rng.random()`` and a right-sided
``searchsorted`` over the float64 cumulative sum of ``p`` divided by its
last entry. So the first index is ``rng.integers(n)``, the k − 1
uniforms are drawn in one call (the same stream), and each step's
cumulative sum and search run on the device. Where the two packages'
squared distances differ in their last bit, a uniform that falls within
that distance of a boundary picks the neighbouring row.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...workflow.pipeline import Estimator, Transformer


def assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_c ‖x − c‖² by the GEMM trick (KMeansPlusPlus.scala:140+)."""
    d2 = ((X * X).sum(dim=1, keepdim=True) - 2.0 * X @ centers.T
          + (centers * centers).sum(dim=1))
    return torch.argmin(d2, dim=1)


class KMeansModel(Transformer):
    """x → one-hot cluster assignment (the reference emits indicator
    vectors for downstream featurization)."""

    def __init__(self, centers: torch.Tensor):
        self.centers = centers

    def assign(self, data):
        """Cluster indices for a dataset."""
        return data.map_batches(lambda X: assign(X, self.centers))

    def batch_fn(self):
        k = self.centers.shape[0]
        return lambda X: F.one_hot(assign(X, self.centers), k).to(X.dtype)


def lloyds(X: torch.Tensor, centers: torch.Tensor,
           num_iters: int) -> torch.Tensor:
    """``num_iters`` Lloyd steps from ``centers``; an empty cluster keeps
    its center."""
    k = centers.shape[0]
    for _ in range(num_iters):
        onehot = F.one_hot(assign(X, centers), k).to(X.dtype)  # (n, k)
        counts = onehot.sum(dim=0)[:, None]
        sums = onehot.T @ X
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1.0), centers)
    return centers


def kmeans_pp_init(X, k: int, rng: np.random.Generator) -> torch.Tensor:
    """k-means++ seeding (KMeansPlusPlus.scala:16-80) of the rows of
    ``X`` (a tensor, seeded where it lives; an array, on the CPU), drawn
    from ``rng`` as `keystone_tpu/nodes/learning/kmeans.py:76-86` draws:
    (k, d) centers."""
    X = torch.as_tensor(X)
    n = X.shape[0]
    centers = torch.empty((k, X.shape[1]), dtype=X.dtype, device=X.device)
    centers[0] = X[int(rng.integers(n))]
    u = torch.as_tensor(rng.random(k - 1), dtype=torch.float64,
                        device=X.device)
    d2 = ((X - centers[0]) ** 2).sum(dim=1)
    for i in range(1, k):
        p = d2 / torch.clamp(d2.sum(), min=1e-12)
        cdf = torch.cumsum(p.to(torch.float64), dim=0)
        cdf = cdf / cdf[-1]
        j = torch.searchsorted(cdf, u[i - 1:i], right=True).clamp_(max=n - 1)
        c = X.index_select(0, j)
        centers[i:i + 1] = c
        d2 = torch.minimum(d2, ((X - c) ** 2).sum(dim=1))
    return centers


class KMeansPlusPlusEstimator(Estimator):
    """k-means++ seeding from ``default_rng(seed)``, then Lloyd's. On a
    mesh every rank seeds and iterates on the rows one process collects
    (`pca.collect_rows`; JAX `kmeans.py:76-108` collects to the host)."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs
    mesh_aware = True  # the rows collected over the data axis

    def __init__(self, num_means: int, num_iters: int = 20, seed: int = 0):
        self.num_means = num_means
        self.num_iters = num_iters
        self.seed = seed

    def fit(self, data) -> KMeansModel:
        from .pca import collect_rows

        X = collect_rows(data)
        rng = np.random.default_rng(self.seed)
        centers0 = kmeans_pp_init(X, self.num_means, rng)
        return KMeansModel(lloyds(X, centers0, self.num_iters))
