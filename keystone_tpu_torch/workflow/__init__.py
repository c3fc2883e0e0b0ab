"""Pipelines and their execution (counterpart of `keystone_tpu/workflow`)."""

from .executor import PrefixMemo, execute
from .pipeline import (
    Estimator,
    ItemTransformer,
    LabelEstimator,
    OptimizableEstimator,
    Pipeline,
    PipelineResult,
    Transformer,
)

__all__ = [
    "Estimator", "ItemTransformer", "LabelEstimator", "OptimizableEstimator",
    "Pipeline", "PipelineResult", "PrefixMemo", "Transformer", "execute",
]
