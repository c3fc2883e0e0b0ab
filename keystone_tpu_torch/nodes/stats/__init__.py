"""Statistics nodes (counterpart of `keystone_tpu/nodes/stats`)."""

from .random_features import (
    CosineRandomFeatures,
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from .scalers import StandardScaler, StandardScalerModel

__all__ = ["CosineRandomFeatures", "LinearRectifier", "PaddedFFT",
           "RandomSignNode", "StandardScaler", "StandardScalerModel"]
