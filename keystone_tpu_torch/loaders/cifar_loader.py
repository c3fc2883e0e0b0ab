"""CIFAR-10 binary loader and the synthetic CIFAR-like task.

Counterpart of `keystone_tpu/loaders/cifar_loader.py` (`:19-115`) and of
`LabeledData` (`keystone_tpu/loaders/csv_loader.py:29`). The binary
format is 1 label byte + 3072 channel-planar bytes per record
(reference loaders/CifarLoader.scala:13-52). `synthetic_cifar` is a
numpy-identical copy of the JAX package's generator, so both packages see
bit-identical arrays for one seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..data.dataset import Dataset
from ..device import DeviceLike, resolve_device

RECORD_BYTES = 1 + 3072


@dataclass
class LabeledData:
    """Aligned (labels, data) pair of datasets (LabeledData.scala:12-15).
    ``labels`` are int class ids; ``data`` is the feature dataset."""

    labels: Dataset
    data: Dataset


def parse_cifar(records: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3073) uint8 records → ((n,32,32,3) float32, (n,) int32)."""
    records = np.asarray(records, np.uint8)
    labels = records[:, 0].astype(np.int32)
    images = (records[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
              .astype(np.float32))
    return images, labels


def cifar_loader(path: str, device: DeviceLike = "cuda") -> LabeledData:
    """Read CIFAR-10 binary batches (a file or a directory of *.bin)."""
    device = resolve_device(device)
    files = (
        [os.path.join(path, f) for f in sorted(os.listdir(path))
         if f.endswith(".bin")]
        if os.path.isdir(path) else [path]
    )
    raw = [np.fromfile(f, dtype=np.uint8) for f in files]
    for f, r in zip(files, raw):
        if r.size % RECORD_BYTES:
            raise ValueError(
                f"{f}: size {r.size} is not a multiple of {RECORD_BYTES}")
    images, labels = parse_cifar(
        np.concatenate(raw).reshape(-1, RECORD_BYTES))
    return LabeledData(labels=Dataset(labels, device=device),
                       data=Dataset(images, device=device))


def synthetic_cifar(
    n_train: int = 2000,
    n_test: int = 500,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.6,
    confusion: float = 0.0,
    device: DeviceLike = "cuda",
) -> Tuple[LabeledData, LabeledData]:
    """A learnable CIFAR-shaped task: each class is a smooth random
    template warped by random shifts + noise; `confusion` > 0 mixes each
    sample's template toward another class's by a weight drawn from
    Uniform(0, confusion). The arrays are made on the host with numpy,
    exactly as the JAX package makes them, then moved to ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(num_classes, 4, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(num_classes, 4))
    amps = rng.uniform(0.5, 1.0, size=(num_classes, 4, 3))
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")

    def template(c):
        img = np.zeros((32, 32, 3), np.float32)
        for i in range(4):
            wave = np.sin(
                freqs[c, i, 0] * yy / 5.0 + freqs[c, i, 1] * xx / 5.0
                + phases[c, i]
            )
            img += wave[:, :, None] * amps[c, i][None, None, :]
        return img

    templates = np.stack([template(c) for c in range(num_classes)])

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        images = templates[labels].copy()
        if confusion > 0.0:
            other = (labels + r.integers(1, num_classes, size=n)) % num_classes
            mix = r.uniform(0.0, confusion, size=n).astype(np.float32)
            images = (1.0 - mix[:, None, None, None]) * images + mix[
                :, None, None, None
            ] * templates[other]
        for i in range(n):
            sy, sx = r.integers(-4, 5, size=2)
            images[i] = np.roll(images[i], (sy, sx), axis=(0, 1))
        images += noise * r.normal(size=images.shape).astype(np.float32)
        images = (images - images.min()) / (images.max() - images.min()) * 255.0
        return LabeledData(
            labels=Dataset(labels, device=device),
            data=Dataset(images.astype(np.float32), device=device),
        )

    return make(n_train, seed + 1), make(n_test, seed + 2)
