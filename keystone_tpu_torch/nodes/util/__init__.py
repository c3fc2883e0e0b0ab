"""Utility nodes (counterpart of `keystone_tpu/nodes/util`)."""

from .basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    ClassLabelIndicatorsFromIntArray,
    MatrixVectorizer,
    MaxClassifier,
    VectorCombiner,
)
from .fusion import FusedBatchTransformer

__all__ = ["Cacher", "ClassLabelIndicatorsFromInt",
           "ClassLabelIndicatorsFromIntArray", "FusedBatchTransformer",
           "MatrixVectorizer", "MaxClassifier", "VectorCombiner"]
