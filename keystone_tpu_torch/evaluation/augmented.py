"""Augmented-example evaluation.

Counterpart of `keystone_tpu/evaluation/augmented.py`
(`AugmentedExamplesEvaluator` `:27-79`, `_borda` `:16-24`; reference
evaluation/AugmentedExamplesEvaluator.scala): the score vectors of all
augmented views of one original example (rows sharing an id) are
aggregated by the mean, the maximum or a Borda rank sum, the aggregate's
argmax is the example's prediction, and the multiclass metrics follow.
Where the JAX package loops over rows in Python, the groups here are
reduced on the scores' device: `index_add_` for the mean and the rank
sums, `scatter_reduce_` for the maximum and the label check. Ids, scores
and labels given as datasets placed over a mesh's data axis are gathered
over it first, their padded rows dropped, so every rank scores the whole
set as one process does.
"""

from __future__ import annotations

import numpy as np
import torch

from .multiclass import MulticlassMetrics, confusion_matrix


def _rows(x):
    """A dataset's ``count`` rows (gathered over a mesh), or ``x``."""
    from ..data.dataset import Dataset
    from ..workflow.pipeline import PipelineResult

    if isinstance(x, PipelineResult):
        x = x.get()
    return x.gather() if isinstance(x, Dataset) else x


def _tensor(x) -> torch.Tensor:
    x = _rows(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def borda_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Each class's rank in the ascending order of its row's scores (0 =
    lowest), ties in row order, as the JAX package's stable argsort
    ranks them. (n, k) → (n, k) int64."""
    order = torch.argsort(scores, dim=1, stable=True)
    cols = torch.arange(scores.shape[1], device=scores.device)
    return torch.empty_like(order).scatter_(1, order,
                                            cols.expand_as(order))


class AugmentedExamplesEvaluator:
    """Group the augmented rows by id, aggregate their scores with
    ``agg`` ("mean", "max" or "borda") and evaluate the argmax of each
    group against the group's label."""

    mesh_aware = True  # the rows gathered over the data axis

    def __init__(self, num_classes: int, agg: str = "mean"):
        if agg not in ("mean", "max", "borda"):
            raise ValueError("agg must be 'mean', 'max', or 'borda'")
        self.num_classes = num_classes
        self.agg = agg

    def evaluate(self, ids, scores, actuals) -> MulticlassMetrics:
        """ids: the original example's id for each augmented row (a
        sequence, an array or a tensor); scores: (n, k) class scores a
        row; actuals: each row's true label, one label an id."""
        scores = _tensor(scores)
        dev = scores.device
        actuals = _tensor(actuals).to(dev).long().reshape(-1)
        ids = _rows(ids)
        if isinstance(ids, torch.Tensor):
            keys, group = torch.unique(ids, return_inverse=True)
            keys = keys.cpu().numpy()
            group = group.to(dev)
        else:
            keys, group = np.unique(np.asarray(ids), return_inverse=True)
            group = torch.as_tensor(group.reshape(-1), device=dev)
        n_groups = len(keys)
        if not scores.shape[0] == actuals.shape[0] == group.shape[0]:
            raise ValueError(f"{group.shape[0]} ids, {scores.shape[0]} score "
                             f"rows and {actuals.shape[0]} labels")
        lo = torch.full((n_groups,), self.num_classes, dtype=torch.int64,
                        device=dev).scatter_reduce_(0, group, actuals, "amin")
        hi = torch.full((n_groups,), -1, dtype=torch.int64,
                        device=dev).scatter_reduce_(0, group, actuals, "amax")
        bad = torch.nonzero(lo != hi).flatten()
        if bad.numel():
            # the reference asserts one distinct label per group
            # (AugmentedExamplesEvaluator.scala:55)
            g = int(bad[0])
            raise ValueError(f"inconsistent labels within augmented group "
                             f"{keys[g]!r}: {int(lo[g])} vs {int(hi[g])}")
        k = scores.shape[1]
        index = group[:, None].expand(-1, k)
        if self.agg == "mean":
            agg = torch.zeros((n_groups, k), dtype=torch.float64,
                              device=dev).index_add_(0, group,
                                                     scores.double())
            agg /= torch.bincount(group, minlength=n_groups)[:, None]
        elif self.agg == "max":
            agg = torch.full((n_groups, k), -torch.inf, dtype=scores.dtype,
                             device=dev).scatter_reduce_(0, index, scores,
                                                         "amax")
        else:
            agg = torch.zeros((n_groups, k), dtype=torch.int64,
                              device=dev).index_add_(0, group,
                                                     borda_ranks(scores))
        return MulticlassMetrics(confusion_matrix(
            torch.argmax(agg, dim=1), lo, self.num_classes))

    def __call__(self, ids, scores, actuals) -> MulticlassMetrics:
        return self.evaluate(ids, scores, actuals)
