"""Data loaders (counterpart of `keystone_tpu/loaders`)."""

from .cifar_loader import cifar_loader, synthetic_cifar
from .csv_loader import LabeledData, csv_data_loader
from .image_loaders import imagenet_loader, load_images_from_tar, voc_loader
from .ooc_loader import (
    out_of_core_from_shards,
    out_of_core_npy_loader,
    synthetic_out_of_core,
)
from .text_loaders import (
    TextLabeledData,
    amazon_reviews_loader,
    newsgroups_loader,
    timit_loader,
)

__all__ = ["LabeledData", "TextLabeledData", "amazon_reviews_loader",
           "cifar_loader", "csv_data_loader", "imagenet_loader",
           "load_images_from_tar", "newsgroups_loader",
           "out_of_core_from_shards", "out_of_core_npy_loader",
           "synthetic_cifar", "synthetic_out_of_core", "timit_loader",
           "voc_loader"]
