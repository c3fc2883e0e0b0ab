"""Multiclass evaluation.

Counterpart of `keystone_tpu/evaluation/multiclass.py` (`:22-158`;
reference evaluation/MulticlassClassifierEvaluator.scala:22-167). The
confusion matrix is one `bincount` over (actual, predicted) pairs on the
device; the derived metrics are computed on the host from the k×k matrix.
On a mesh (`parallel/`) each rank counts its valid rows (its padded rows
go to a bin that is dropped) and one all-reduce over ``data`` gives
every rank the global matrix (JAX `:22-25, 137` under GSPMD).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.collectives import all_reduce


def confusion_matrix(preds: torch.Tensor, actuals: torch.Tensor,
                     num_classes: int, mask=None, mesh=None) -> np.ndarray:
    """(k, k) float64 counts, rows = actual, cols = predicted. With
    ``mesh``, of every rank's rows: ``mask`` (None: all valid) marks this
    rank's valid ones."""
    k2 = num_classes * num_classes
    idx = actuals.long().reshape(-1) * num_classes + preds.long().reshape(-1)
    if mask is not None:
        idx = torch.where(mask.reshape(-1), idx, k2)
    cm = torch.bincount(idx, minlength=k2 + (mask is not None))[:k2]
    if mesh is not None:
        cm = all_reduce(cm.contiguous(), mesh)
    return cm.reshape(num_classes, num_classes).cpu().numpy().astype(np.float64)


@dataclass
class MulticlassMetrics:
    confusion: np.ndarray  # (k, k), rows=actual, cols=predicted

    @property
    def num_classes(self) -> int:
        return self.confusion.shape[0]

    @property
    def total(self) -> float:
        return float(self.confusion.sum())

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion)) / max(self.total, 1.0)

    @property
    def error(self) -> float:
        return 1.0 - self.accuracy

    def class_precision(self, c: int) -> float:
        col = self.confusion[:, c].sum()
        return float(self.confusion[c, c] / col) if col else 0.0

    def class_recall(self, c: int) -> float:
        row = self.confusion[c, :].sum()
        return float(self.confusion[c, c] / row) if row else 0.0

    def class_f1(self, c: int) -> float:
        p, r = self.class_precision(c), self.class_recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def class_fbeta(self, c: int, beta: float) -> float:
        """F_β = (1+β²)·P·R / (β²·P + R)."""
        p, r = self.class_precision(c), self.class_recall(c)
        denom = beta * beta * p + r
        return (1 + beta * beta) * p * r / denom if denom else 0.0

    def macro_fbeta(self, beta: float) -> float:
        return float(np.mean(
            [self.class_fbeta(c, beta) for c in range(self.num_classes)]))

    @property
    def macro_precision(self) -> float:
        return float(np.mean(
            [self.class_precision(c) for c in range(self.num_classes)]))

    @property
    def macro_recall(self) -> float:
        return float(np.mean(
            [self.class_recall(c) for c in range(self.num_classes)]))

    @property
    def macro_f1(self) -> float:
        return float(np.mean(
            [self.class_f1(c) for c in range(self.num_classes)]))

    @property
    def micro_precision(self) -> float:
        # single-label multiclass: micro P = micro R = accuracy
        return self.accuracy

    micro_recall = micro_precision

    @property
    def micro_f1(self) -> float:
        return self.accuracy

    def summary(self, class_names=None) -> str:
        """Mahout-style pretty printer
        (MulticlassClassifierEvaluator.scala:123-167)."""
        k = self.num_classes
        names = class_names or [str(i) for i in range(k)]
        lines = [
            "=" * 48,
            "Summary",
            "-" * 48,
            f"Accuracy: {self.accuracy:.4f}",
            f"Macro Precision/Recall/F1: "
            f"{self.macro_precision:.4f}/{self.macro_recall:.4f}/{self.macro_f1:.4f}",
            "-" * 48,
            "Confusion matrix (rows=actual, cols=predicted)",
        ]
        lines.append("      " + " ".join(f"{n[:6]:>6}" for n in names))
        for i in range(k):
            row = " ".join(f"{int(self.confusion[i, j]):6d}" for j in range(k))
            lines.append(f"{names[i][:6]:>6} {row}")
        lines.append("=" * 48)
        return "\n".join(lines)


class MulticlassClassifierEvaluator:
    """Evaluate int predictions vs int actuals → MulticlassMetrics; on a
    mesh, the global matrix on every rank."""

    mesh_aware = True  # the confusion matrix all-reduced over the data axis

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predictions, actuals) -> MulticlassMetrics:
        from ..data.dataset import Dataset
        from ..workflow.pipeline import PipelineResult

        if isinstance(predictions, PipelineResult):
            predictions = predictions.get()
        if isinstance(actuals, PipelineResult):
            actuals = actuals.get()

        def rows(x):
            if isinstance(x, Dataset):
                return x.array
            return torch.as_tensor(np.asarray(x))

        p, a = rows(predictions), rows(actuals)
        if p.shape != a.shape:
            raise ValueError(
                f"predictions/actuals misaligned: {tuple(p.shape)} vs "
                f"{tuple(a.shape)}")
        mesh = getattr(predictions, "mesh", None)
        if mesh != getattr(actuals, "mesh", None):
            raise ValueError("predictions and actuals placed on different "
                             "meshes")
        mask = (predictions.mask if mesh is not None
                and predictions.has_padding else None)
        return MulticlassMetrics(
            confusion_matrix(p, a.to(p.device), self.num_classes, mask,
                             mesh))

    def __call__(self, predictions, actuals) -> MulticlassMetrics:
        return self.evaluate(predictions, actuals)
