"""Binary-classifier evaluation.

Counterpart of `keystone_tpu/evaluation/binary.py` (`:13-68`; reference
evaluation/BinaryClassifierEvaluator.scala:17-79): contingency-table
metrics of boolean predictions against actuals, counted on the host after
one transfer of each. On a mesh's data axis the rows are gathered first,
as `evaluation/augmented.py` gathers them (a `Dataset`'s `numpy`, a
`HostDataset`'s `gather_items`; padded rows dropped), so every rank
counts one process's table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BinaryClassifierMetrics:
    tp: float
    fp: float
    tn: float
    fn: float

    @property
    def accuracy(self) -> float:
        total = self.tp + self.fp + self.tn + self.fn
        return (self.tp + self.tn) / max(total, 1.0)

    @property
    def precision(self) -> float:
        denom = self.tp + self.fp
        return self.tp / denom if denom else 1.0

    @property
    def recall(self) -> float:
        denom = self.tp + self.fn
        return self.tp / denom if denom else 1.0

    @property
    def specificity(self) -> float:
        denom = self.tn + self.fp
        return self.tn / denom if denom else 1.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0


def _host_bools(x) -> np.ndarray:
    """A flat boolean host array from a lazy result, a dataset (every
    rank's rows on a mesh), a tensor or an array."""
    from ..data.dataset import Dataset, HostDataset
    from ..workflow.pipeline import PipelineResult

    if isinstance(x, PipelineResult):
        x = x.get()
    if isinstance(x, HostDataset):
        x = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
             for v in x.gather_items()]
    elif isinstance(x, Dataset):
        x = x.numpy()
    elif isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(bool).ravel()


class BinaryClassifierEvaluator:
    mesh_aware = True  # the rows gathered over the data axis

    def evaluate(self, predictions, actuals) -> BinaryClassifierMetrics:
        p, a = _host_bools(predictions), _host_bools(actuals)
        if p.shape != a.shape:
            raise ValueError(f"predictions/actuals misaligned: {p.shape} "
                             f"vs {a.shape}")
        return BinaryClassifierMetrics(
            tp=float(np.sum(p & a)),
            fp=float(np.sum(p & ~a)),
            tn=float(np.sum(~p & ~a)),
            fn=float(np.sum(~p & a)),
        )

    def __call__(self, predictions, actuals) -> BinaryClassifierMetrics:
        return self.evaluate(predictions, actuals)
