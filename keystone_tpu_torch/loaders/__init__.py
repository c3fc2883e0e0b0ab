"""Data loaders (counterpart of `keystone_tpu/loaders`)."""

from .cifar_loader import LabeledData, cifar_loader, synthetic_cifar

__all__ = ["LabeledData", "cifar_loader", "synthetic_cifar"]
