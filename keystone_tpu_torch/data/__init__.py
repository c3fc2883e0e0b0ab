"""Datasets (counterpart of `keystone_tpu/data`)."""

from .dataset import (
    Dataset,
    HostDataset,
    ZippedDataset,
    ZippedHostDataset,
    zip_datasets,
)

__all__ = ["Dataset", "HostDataset", "ZippedDataset", "ZippedHostDataset",
           "zip_datasets"]
