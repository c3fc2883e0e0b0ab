"""Pipelines and their execution (counterpart of `keystone_tpu/workflow`)."""

from .executor import PrefixMemo, execute
from .pipeline import (
    Estimator,
    LabelEstimator,
    Pipeline,
    PipelineResult,
    Transformer,
)

__all__ = [
    "Estimator", "LabelEstimator", "Pipeline", "PipelineResult",
    "PrefixMemo", "Transformer", "execute",
]
