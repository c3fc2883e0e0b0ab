"""Row-wise normalization and down-sampling nodes.

Counterpart of `keystone_tpu/nodes/stats/normalization.py` (`:19-107`;
reference nodes/stats/{NormalizeRows,SignedHellingerMapper,
Sampling}.scala):

- `NormalizeRows`: each item over all its axes divided by its L2 norm
  (at least ``eps``);
- `SignedHellingerMapper`: sign(x)·sqrt(|x|);
- `Sampler` and `ColumnSampler`: deterministic down-sampling, the rows
  drawn by numpy's ``default_rng(seed).choice`` without replacement and
  sorted, as the JAX package draws them, so both keep the same rows.

The first two are stages the elementwise chain kernel can absorb
(`fuse` gives the JAX package's keys, `chain_kernels.py:210, 221`); over
a `HostDataset` they run on each bucket of equal-shape items.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data.dataset import Dataset, HostDataset
from ...workflow.pipeline import Transformer


def _sorted_choice(n: int, size: int, seed: int) -> np.ndarray:
    idx = np.random.default_rng(seed).choice(n, size, replace=False)
    idx.sort()
    return idx


class NormalizeRows(Transformer):
    """x / max(‖x‖₂, eps) per item (NormalizeRows.scala:10)."""

    precision_tolerance = "tolerant"  # per-item norm: featurize scale

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, eps: float = 2.2e-16):
        self.eps = eps

    def batch_fn(self):
        def fn(x):
            axes = tuple(range(1, x.ndim))
            norms = torch.sqrt((x * x).sum(dim=axes, keepdim=True))
            return x / torch.clamp(norms, min=self.eps)

        return fn

    def fuse(self):
        return ("NormalizeRows",), (np.float64(self.eps),)


class SignedHellingerMapper(Transformer):
    """sign(x)·sqrt(|x|) (SignedHellingerMapper.scala:12-22)."""

    precision_tolerance = "tolerant"  # elementwise sign·sqrt

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        return lambda x: torch.sign(x) * torch.sqrt(torch.abs(x))

    def fuse(self):
        return ("SignedHellingerMapper",), ()


class Sampler(Transformer):
    """At most ``size`` items of a dataset, drawn without replacement and
    kept in order (a FunctionNode in the reference); a single item passes
    through."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.seed = seed

    def apply(self, x):
        return x

    def apply_batch(self, data):
        n = len(data)
        if n <= self.size:
            return data
        idx = _sorted_choice(n, self.size, self.seed)
        if isinstance(data, HostDataset):
            items = data.items
            return HostDataset([items[i] for i in idx], device=data.device)
        picked = data.array[torch.as_tensor(idx, device=data.device)]
        return Dataset(picked, count=self.size)


class ColumnSampler(Transformer):
    """At most ``num_cols`` rows of each item's (rows × dim) matrix
    (Sampling.scala:12-25): every item with n rows keeps the same rows,
    so a bucket of equal-shape items is sampled in one gather."""

    chunkable = True  # per-item: distributes over chunks

    def __init__(self, num_cols: int, seed: int = 0):
        self.num_cols = num_cols
        self.seed = seed

    def batch_fn(self):
        def fn(x):
            n = x.shape[1]
            if n <= self.num_cols:
                return x
            idx = _sorted_choice(n, self.num_cols, self.seed)
            return x[:, torch.as_tensor(idx, device=x.device)]

        return fn
