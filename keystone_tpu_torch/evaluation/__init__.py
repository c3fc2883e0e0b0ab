"""Evaluators (counterpart of `keystone_tpu/evaluation`)."""

from .augmented import AugmentedExamplesEvaluator
from .binary import BinaryClassifierEvaluator, BinaryClassifierMetrics
from .map_evaluator import MeanAveragePrecisionEvaluator
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = ["AugmentedExamplesEvaluator", "BinaryClassifierEvaluator",
           "BinaryClassifierMetrics", "MeanAveragePrecisionEvaluator",
           "MulticlassClassifierEvaluator", "MulticlassMetrics"]
