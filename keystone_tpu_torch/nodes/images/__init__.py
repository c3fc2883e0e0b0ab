"""Image nodes (counterpart of `keystone_tpu/nodes/images`)."""

from .core import (
    CenterCornerPatcher,
    Convolver,
    Cropper,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    RandomImageTransformer,
    RandomPatcher,
    SymmetricRectifier,
    Windower,
)
from .descriptors import LCSExtractor
from .extractors import (
    ImageExtractor,
    LabelExtractor,
    MultiLabeledImageExtractor,
    MultiLabelExtractor,
)
from .fisher_vector import (
    EncEvalGMMFisherVectorEstimator,
    FisherVector,
    GMMFisherVectorEstimator,
    ScalaGMMFisherVectorEstimator,
)
from .sift import SIFTExtractor, SIFTExtractorInterface

__all__ = ["CenterCornerPatcher", "Convolver", "Cropper",
           "EncEvalGMMFisherVectorEstimator", "FisherVector",
           "GMMFisherVectorEstimator", "GrayScaler", "ImageExtractor",
           "ImageVectorizer", "LCSExtractor", "LabelExtractor",
           "MultiLabelExtractor", "MultiLabeledImageExtractor",
           "PixelScaler", "Pooler", "RandomImageTransformer",
           "RandomPatcher", "SIFTExtractor", "SIFTExtractorInterface",
           "ScalaGMMFisherVectorEstimator", "SymmetricRectifier",
           "Windower"]
