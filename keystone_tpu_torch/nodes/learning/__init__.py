"""Learning nodes (counterpart of `keystone_tpu/nodes/learning`)."""

from .block_ls import BlockLeastSquaresEstimator, BlockLinearMapper, bcd_fit
from .zca import ZCAWhitener, zca_from_covariance

__all__ = ["BlockLeastSquaresEstimator", "BlockLinearMapper", "bcd_fit",
           "ZCAWhitener", "zca_from_covariance"]
