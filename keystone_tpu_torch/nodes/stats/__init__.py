"""Statistics nodes (counterpart of `keystone_tpu/nodes/stats`)."""

from .normalization import (
    ColumnSampler,
    NormalizeRows,
    Sampler,
    SignedHellingerMapper,
)
from .random_features import (
    CosineRandomFeatures,
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from .scalers import StandardScaler, StandardScalerModel

__all__ = ["ColumnSampler", "CosineRandomFeatures", "LinearRectifier",
           "NormalizeRows", "PaddedFFT", "RandomSignNode", "Sampler",
           "SignedHellingerMapper", "StandardScaler", "StandardScalerModel"]
