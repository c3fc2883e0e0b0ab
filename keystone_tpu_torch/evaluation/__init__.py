"""Evaluators (counterpart of `keystone_tpu/evaluation`)."""

from .augmented import AugmentedExamplesEvaluator
from .map_evaluator import MeanAveragePrecisionEvaluator
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = ["AugmentedExamplesEvaluator", "MeanAveragePrecisionEvaluator",
           "MulticlassClassifierEvaluator", "MulticlassMetrics"]
