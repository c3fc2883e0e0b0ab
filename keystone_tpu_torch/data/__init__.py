"""Datasets (counterpart of `keystone_tpu/data`)."""

from .dataset import Dataset, ZippedDataset, zip_datasets

__all__ = ["Dataset", "ZippedDataset", "zip_datasets"]
