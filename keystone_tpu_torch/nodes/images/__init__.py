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

__all__ = ["CenterCornerPatcher", "Convolver", "Cropper", "GrayScaler",
           "ImageVectorizer", "PixelScaler", "Pooler",
           "RandomImageTransformer", "RandomPatcher", "SymmetricRectifier",
           "Windower"]
