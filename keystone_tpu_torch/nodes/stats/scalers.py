"""Feature standardization.

Counterpart of `keystone_tpu/nodes/stats/scalers.py` (`_moments`,
`_scale`, `:22-84`; reference nodes/stats/StandardScaler.scala:36-60).
The moments are one pass of sums over the rows, as in the JAX package;
with one device there are no padded rows, so the row mask is all ones
and the scale needs no masking.
"""

from __future__ import annotations

import torch

from ...telemetry.instrument import record_dispatch
from ...workflow.pipeline import Estimator, Transformer


def moments(x: torch.Tensor, count: int, normalize_std: bool):
    """Per-feature mean and unbiased std (std 1 where it is 0, and
    everywhere when ``normalize_std`` is False)."""
    s = x.sum(dim=0)
    s2 = (x * x).sum(dim=0)
    mean = s / count
    if not normalize_std:
        return mean, torch.ones_like(mean)
    var = (s2 - count * mean * mean) / max(count - 1.0, 1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return mean, torch.where(std == 0.0, torch.ones_like(std), std)


class StandardScalerModel(Transformer):
    """(x − mean) / std, or x − mean when ``std`` is None."""

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    #: the JAX package's batch path re-zeros padded rows after this
    #: stage (`_scale`'s mask), so a chain kernel applies the row mask
    #: at its place in the chain (`scalers.py:42-75`)
    fuse_masks_output = True

    def __init__(self, mean: torch.Tensor, std=None):
        self.mean = mean
        self.std = std

    def batch_fn(self):
        if self.std is None:
            return lambda x: x - self.mean
        return lambda x: (x - self.mean) / self.std

    def fuse(self):
        """The JAX package's static key and parameters
        (`scalers.py:66-75`)."""
        if self.std is None:
            return ("StandardScaler", "center"), (self.mean,)
        return ("StandardScaler", "scale"), (self.mean, self.std)


class StandardScaler(Estimator):
    """Fit per-feature mean/std (StandardScaler.scala:36-60)."""

    fusable_fit = True

    def __init__(self, normalize_std_dev: bool = True):
        self.normalize_std_dev = normalize_std_dev

    def fit(self, data) -> StandardScalerModel:
        record_dispatch()  # one batched call (JAX :122)
        mean, std = moments(data.array, data.count, self.normalize_std_dev)
        return StandardScalerModel(mean,
                                   std if self.normalize_std_dev else None)
