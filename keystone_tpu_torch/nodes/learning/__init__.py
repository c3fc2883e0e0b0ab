"""Learning nodes (counterpart of `keystone_tpu/nodes/learning`)."""

from .block_ls import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    bcd_fit,
    raise_if_unfactored,
)
from .classifiers import (
    LinearDiscriminantAnalysis,
    LogisticRegressionEstimator,
    LogisticRegressionModel,
    NaiveBayesEstimator,
    NaiveBayesModel,
)
from .kernels import (
    BlockKernelMatrix,
    GaussianKernelGenerator,
    GaussianKernelTransformer,
    KernelBlockLinearMapper,
    KernelRidgeRegression,
)
from .gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from .kmeans import KMeansModel, KMeansPlusPlusEstimator
from .linear import LinearMapEstimator, LinearMapper
from .pca import (
    ApproximatePCAEstimator,
    BatchPCATransformer,
    ColumnPCAEstimator,
    DistributedPCAEstimator,
    PCAEstimator,
    PCATransformer,
)
from .weighted_ls import (
    BlockWeightedLeastSquaresEstimator,
    PerClassWeightedLeastSquares,
)
from .zca import ZCAWhitener, ZCAWhitenerEstimator, zca_from_covariance

__all__ = ["ApproximatePCAEstimator", "BatchPCATransformer",
           "BlockKernelMatrix", "BlockLeastSquaresEstimator",
           "BlockLinearMapper", "BlockWeightedLeastSquaresEstimator",
           "ColumnPCAEstimator", "DistributedPCAEstimator",
           "GaussianKernelGenerator", "GaussianKernelTransformer",
           "GaussianMixtureModel", "GaussianMixtureModelEstimator",
           "KMeansModel", "KMeansPlusPlusEstimator",
           "KernelBlockLinearMapper", "KernelRidgeRegression",
           "LinearDiscriminantAnalysis", "LinearMapEstimator",
           "LinearMapper", "LogisticRegressionEstimator",
           "LogisticRegressionModel", "NaiveBayesEstimator",
           "NaiveBayesModel", "PCAEstimator",
           "PCATransformer", "PerClassWeightedLeastSquares", "ZCAWhitener",
           "ZCAWhitenerEstimator",
           "bcd_fit", "raise_if_unfactored", "zca_from_covariance"]
