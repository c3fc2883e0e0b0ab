"""Data loaders (counterpart of `keystone_tpu/loaders`)."""

from .cifar_loader import cifar_loader, synthetic_cifar
from .csv_loader import LabeledData, csv_data_loader
from .text_loaders import (
    TextLabeledData,
    amazon_reviews_loader,
    newsgroups_loader,
    timit_loader,
)

__all__ = ["LabeledData", "TextLabeledData", "amazon_reviews_loader",
           "cifar_loader", "csv_data_loader", "newsgroups_loader",
           "synthetic_cifar", "timit_loader"]
