"""VOC-style mean average precision.

Counterpart of `keystone_tpu/evaluation/map_evaluator.py` (`:13-58`;
reference evaluation/MeanAveragePrecisionEvaluator.scala:11-86): per
class, the examples ranked by score, descending, with a stable sort,
and the 11-point interpolated average precision. The scores come to the
host in one transfer and the ranking runs in numpy, so ties break as
they do in the JAX package. Scores and actuals given as datasets placed
over a mesh's data axis are gathered over it first (padded rows
dropped), so every rank ranks the whole set as one process does; a list
of actuals is the whole set's.
"""

from __future__ import annotations

import numpy as np
import torch


class MeanAveragePrecisionEvaluator:
    """``actuals``: each example's true class ids (multi-label);
    ``scores``: (n, k) scores. Returns the per-class AP (its mean is
    the mAP)."""

    mesh_aware = True  # the rows gathered over the data axis

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, scores, actuals) -> np.ndarray:
        from ..data.dataset import Dataset, HostDataset
        from ..workflow.pipeline import PipelineResult

        if isinstance(scores, PipelineResult):
            scores = scores.get()
        if isinstance(scores, Dataset):
            scores = scores.numpy()
        elif isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        scores = np.asarray(scores)
        if isinstance(actuals, PipelineResult):
            actuals = actuals.get()
        if isinstance(actuals, HostDataset) and actuals.mesh is not None:
            actuals = actuals.gather_items()
        elif isinstance(actuals, (Dataset, HostDataset)):
            actuals = actuals.numpy()
        if len(actuals) != scores.shape[0]:
            raise ValueError(f"{scores.shape[0]} score rows and "
                             f"{len(actuals)} actuals")

        k = self.num_classes
        member = np.zeros((len(actuals), k), bool)
        for i, a in enumerate(actuals):
            ids = np.atleast_1d(np.asarray(a, np.int64))
            member[i, ids[(ids >= 0) & (ids < k)]] = True
        aps = np.zeros(k)
        for c in range(k):
            y_true = member[:, c]
            order = np.argsort(-scores[:, c], kind="stable")
            tp = y_true[order]
            npos = tp.sum()
            if npos == 0:
                continue
            cum_tp = np.cumsum(tp)
            precision = cum_tp / (np.arange(len(tp)) + 1)
            recall = cum_tp / npos
            # 11-point interpolation (MeanAveragePrecisionEvaluator.scala:
            # 40-86)
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t]
                ap += (p.max() if p.size else 0.0) / 11.0
            aps[c] = ap
        return aps

    def __call__(self, scores, actuals) -> np.ndarray:
        return self.evaluate(scores, actuals)
