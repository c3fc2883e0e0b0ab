"""Image nodes (counterpart of `keystone_tpu/nodes/images`)."""

from .core import (
    Convolver,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)

__all__ = ["Convolver", "ImageVectorizer", "PixelScaler", "Pooler",
           "SymmetricRectifier"]
