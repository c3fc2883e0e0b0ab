"""Utility nodes (counterpart of `keystone_tpu/nodes/util`)."""

from .basic import Cacher, ClassLabelIndicatorsFromInt, MaxClassifier
from .fusion import FusedBatchTransformer

__all__ = ["Cacher", "ClassLabelIndicatorsFromInt", "FusedBatchTransformer",
           "MaxClassifier"]
