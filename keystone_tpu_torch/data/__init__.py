"""Datasets (counterpart of `keystone_tpu/data`)."""

from .dataset import Dataset

__all__ = ["Dataset"]
