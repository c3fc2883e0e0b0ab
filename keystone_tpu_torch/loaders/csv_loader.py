"""CSV loading and the `LabeledData` pair.

Counterpart of `keystone_tpu/loaders/csv_loader.py`: `csv_data_loader`
(`:14-26`; reference loaders/CsvDataLoader.scala:10-31) and `LabeledData`
with `from_arrays` and `label_featured_csv` (`:29-56`;
loaders/LabeledData.scala:12-15). The JAX package parses float32 CSVs
with its native parser where built, else numpy
(`utils/native_io.py::parse_csv`, `:110-128`); the port keeps the numpy
parse, `np.loadtxt(..., dtype=float32, ndmin=2)`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data.dataset import Dataset
from ..device import DeviceLike, resolve_device


def parse_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """Dense float CSV → (rows, cols) float32."""
    return np.loadtxt(path, delimiter=delimiter, dtype=np.float32, ndmin=2)


def csv_data_loader(path: str, delimiter: str = ",",
                    device: DeviceLike = "cuda") -> Dataset:
    """A dense float32 CSV as a Dataset on ``device``."""
    device = resolve_device(device)
    return Dataset(parse_csv(path, delimiter), device=device)


@dataclass
class LabeledData:
    """Aligned (labels, data) pair of datasets (LabeledData.scala:12-15).
    ``labels`` are int class ids; ``data`` is the feature dataset."""

    labels: Dataset
    data: Dataset

    @staticmethod
    def from_arrays(labels, features,
                    device: DeviceLike = "cuda") -> "LabeledData":
        """Int32 labels and the features, both on ``device``."""
        device = resolve_device(device)
        labels = np.asarray(labels)
        features = np.asarray(features)
        if labels.shape[0] != features.shape[0]:
            raise ValueError("labels and features must align")
        return LabeledData(labels=Dataset(labels.astype(np.int32),
                                          device=device),
                           data=Dataset(features, device=device))

    @staticmethod
    def label_featured_csv(path: str, label_col: int = 0,
                           device: DeviceLike = "cuda") -> "LabeledData":
        """A CSV whose ``label_col`` holds the integer label and whose
        other columns are the features (the reference's MNIST format,
        MnistRandomFFT.scala:30-38)."""
        device = resolve_device(device)
        arr = parse_csv(path)
        labels = arr[:, label_col].astype(np.int32)
        features = np.delete(arr, label_col, axis=1)
        return LabeledData.from_arrays(labels, features, device)
