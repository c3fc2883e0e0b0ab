"""Evaluators (counterpart of `keystone_tpu/evaluation`)."""

from .augmented import AugmentedExamplesEvaluator
from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = ["AugmentedExamplesEvaluator", "MulticlassClassifierEvaluator",
           "MulticlassMetrics"]
