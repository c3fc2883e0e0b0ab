"""Evaluators (counterpart of `keystone_tpu/evaluation`)."""

from .multiclass import MulticlassClassifierEvaluator, MulticlassMetrics

__all__ = ["MulticlassClassifierEvaluator", "MulticlassMetrics"]
