"""Utility nodes (counterpart of `keystone_tpu/nodes/util`)."""

from .basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    ClassLabelIndicatorsFromIntArray,
    Densify,
    FloatToDouble,
    Identity,
    MatrixVectorizer,
    MaxClassifier,
    Shuffler,
    Sparsify,
    TopKClassifier,
    VectorCombiner,
)
from .fusion import FusedBatchTransformer
from .sparse_features import (
    AllSparseFeatures,
    CommonSparseFeatures,
    SparseFeatureVectorizer,
)
from .vector_splitter import VectorSplitter

__all__ = ["AllSparseFeatures", "Cacher", "ClassLabelIndicatorsFromInt",
           "ClassLabelIndicatorsFromIntArray", "CommonSparseFeatures",
           "Densify", "FloatToDouble", "FusedBatchTransformer", "Identity",
           "MatrixVectorizer", "MaxClassifier", "Shuffler",
           "SparseFeatureVectorizer", "Sparsify", "TopKClassifier",
           "VectorCombiner", "VectorSplitter"]
