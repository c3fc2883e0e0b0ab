"""Utility nodes (counterpart of `keystone_tpu/nodes/util`)."""

from .basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    ClassLabelIndicatorsFromIntArray,
    Densify,
    MatrixVectorizer,
    MaxClassifier,
    Sparsify,
    VectorCombiner,
)
from .fusion import FusedBatchTransformer
from .sparse_features import (
    AllSparseFeatures,
    CommonSparseFeatures,
    SparseFeatureVectorizer,
)

__all__ = ["AllSparseFeatures", "Cacher", "ClassLabelIndicatorsFromInt",
           "ClassLabelIndicatorsFromIntArray", "CommonSparseFeatures",
           "Densify", "FusedBatchTransformer", "MatrixVectorizer",
           "MaxClassifier", "SparseFeatureVectorizer", "Sparsify",
           "VectorCombiner"]
