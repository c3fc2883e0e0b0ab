"""Learning nodes (counterpart of `keystone_tpu/nodes/learning`)."""

from .block_ls import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    bcd_fit,
    raise_if_unfactored,
)
from .kernels import (
    BlockKernelMatrix,
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from .linear import LinearMapEstimator, LinearMapper
from .zca import ZCAWhitener, zca_from_covariance

__all__ = ["BlockKernelMatrix", "BlockLeastSquaresEstimator",
           "BlockLinearMapper", "GaussianKernelGenerator",
           "GaussianKernelTransformer", "KernelBlockLinearMapper",
           "KernelRidgeRegression", "LinearMapEstimator", "LinearMapper",
           "ZCAWhitener", "bcd_fit", "raise_if_unfactored",
           "zca_from_covariance"]
