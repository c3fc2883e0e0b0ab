"""Learning nodes (counterpart of `keystone_tpu/nodes/learning`)."""

from .block_ls import (
    BlockLeastSquaresEstimator,
    BlockLinearMapper,
    bcd_fit,
    raise_if_unfactored,
)
from .calibrate import (
    CostWeights,
    calibrate_cost_weights,
    default_weights,
    host_bandwidth,
    machine_rates,
    write_calibration,
)
from .classifiers import (
    LinearDiscriminantAnalysis,
    LogisticRegressionEstimator,
    LogisticRegressionModel,
    NaiveBayesEstimator,
    NaiveBayesModel,
)
from .cost_model import (
    BlockSolverCostModel,
    CostModel,
    CostProfile,
    ExactSolverCostModel,
    LBFGSCostModel,
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
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .least_squares import LeastSquaresEstimator
from .linear import (
    LinearMapEstimator,
    LinearMapper,
    LocalLeastSquaresEstimator,
    SparseLinearMapper,
)
from .pca import (
    ApproximatePCAEstimator,
    BatchPCATransformer,
    ColumnPCAEstimator,
    DistributedPCACostModel,
    DistributedPCAEstimator,
    LocalPCACostModel,
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
           "BlockLinearMapper", "BlockSolverCostModel",
           "BlockWeightedLeastSquaresEstimator", "ColumnPCAEstimator",
           "CostModel", "CostProfile", "CostWeights", "DenseLBFGSwithL2",
           "DistributedPCACostModel", "DistributedPCAEstimator",
           "ExactSolverCostModel", "GaussianKernelGenerator",
           "GaussianKernelTransformer", "GaussianMixtureModel",
           "GaussianMixtureModelEstimator", "KMeansModel",
           "KMeansPlusPlusEstimator", "KernelBlockLinearMapper",
           "KernelRidgeRegression", "LBFGSCostModel",
           "LeastSquaresEstimator", "LinearDiscriminantAnalysis",
           "LinearMapEstimator", "LinearMapper", "LocalLeastSquaresEstimator",
           "LocalPCACostModel", "LogisticRegressionEstimator",
           "LogisticRegressionModel", "NaiveBayesEstimator",
           "NaiveBayesModel", "PCAEstimator", "PCATransformer",
           "PerClassWeightedLeastSquares", "SparseLBFGSwithL2",
           "SparseLinearMapper", "ZCAWhitener", "ZCAWhitenerEstimator",
           "bcd_fit", "calibrate_cost_weights", "default_weights",
           "host_bandwidth", "machine_rates", "raise_if_unfactored",
           "write_calibration", "zca_from_covariance"]
