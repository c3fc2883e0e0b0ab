"""Utility nodes (counterpart of `keystone_tpu/nodes/util`)."""

from .basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
    VectorCombiner,
)
from .fusion import FusedBatchTransformer

__all__ = ["Cacher", "ClassLabelIndicatorsFromInt", "FusedBatchTransformer",
           "MaxClassifier", "VectorCombiner"]
