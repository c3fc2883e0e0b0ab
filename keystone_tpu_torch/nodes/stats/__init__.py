"""Statistics nodes (counterpart of `keystone_tpu/nodes/stats`)."""

from .scalers import StandardScaler, StandardScalerModel

__all__ = ["StandardScaler", "StandardScalerModel"]
