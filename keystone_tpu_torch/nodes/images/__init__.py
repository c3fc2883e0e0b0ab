"""Image nodes (counterpart of `keystone_tpu/nodes/images`)."""

from .core import (
    Convolver,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)

__all__ = ["Convolver", "GrayScaler", "ImageVectorizer", "PixelScaler",
           "Pooler", "SymmetricRectifier"]
