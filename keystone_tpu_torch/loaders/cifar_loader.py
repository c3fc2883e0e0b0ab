"""CIFAR-10 binary loader and the synthetic CIFAR-like task.

Counterpart of `keystone_tpu/loaders/cifar_loader.py` (`:19-115`);
`LabeledData` lives in `csv_loader.py`, as in the JAX package. The binary
format is 1 label byte + 3072 channel-planar bytes per record
(reference loaders/CifarLoader.scala:13-52). `synthetic_cifar` is a
numpy-identical copy of the JAX package's generator, so both packages see
bit-identical arrays for one seed. `synthetic_cifar_out_of_core` draws
the same task a shard at a time, for training sets larger than the
card (`loaders/ooc_loader.py`); it has no JAX counterpart.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..device import DeviceLike, resolve_device
from .csv_loader import LabeledData

RECORD_BYTES = 1 + 3072


def parse_cifar(records: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 3073) uint8 records → ((n,32,32,3) float32, (n,) int32)."""
    records = np.asarray(records, np.uint8)
    labels = records[:, 0].astype(np.int32)
    images = (records[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
              .astype(np.float32))
    return images, labels


def cifar_loader(path: str, device: DeviceLike = "cuda",
                 mesh=None) -> LabeledData:
    """Read CIFAR-10 binary batches (a file or a directory of *.bin)."""
    device = resolve_device(device)
    files = (
        [os.path.join(path, f) for f in sorted(os.listdir(path))
         if f.endswith(".bin")]
        if os.path.isdir(path) else [path]
    )
    from ..utils.batching import prefetch_iterator

    def read(f):
        raw = np.fromfile(f, dtype=np.uint8)
        if raw.size % RECORD_BYTES:
            raise ValueError(
                f"{f}: size {raw.size} is not a multiple of {RECORD_BYTES}")
        return raw.reshape(-1, RECORD_BYTES)

    # file k+1 is read in a bounded background queue while file k parses
    # (`keystone_tpu/loaders/cifar_loader.py:28-43`); parsing file by
    # file is record for record the parse of the concatenated records
    parsed = [parse_cifar(records)
              for records in prefetch_iterator(read(f) for f in files)]
    images = np.concatenate([p[0] for p in parsed])
    labels = np.concatenate([p[1] for p in parsed])
    return LabeledData(labels=Dataset(labels, device=device, mesh=mesh),
                       data=Dataset(images, device=device, mesh=mesh))


def cifar_templates(num_classes: int = 10, seed: int = 0) -> np.ndarray:
    """(num_classes, 32, 32, 3) float32 class templates: each a sum of
    four smooth random waves, drawn from ``seed``."""
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

    return np.stack([template(c) for c in range(num_classes)])


class CifarShards:
    """The draws of `synthetic_cifar_out_of_core`: the class templates
    of `cifar_templates` rolled by every shift of -4..4 pixels an axis,
    and 4,096 fields of Gaussian noise of deviation ``noise`` drawn once
    from ``seed``, both mapped once to pixel values by one fixed affine
    map (the templates' range widened by 4 deviations of the noise), so
    that every shard, and a test set drawn the same way, share one
    scale."""

    NOISE_FIELDS = 4096

    def __init__(self, num_classes: int = 10, seed: int = 0,
                 noise: float = 1.2, confusion: float = 0.6):
        bank = np.stack([np.stack([np.roll(t, (sy, sx), axis=(0, 1))
                                   for sy in range(-4, 5)
                                   for sx in range(-4, 5)])
                         for t in cifar_templates(num_classes, seed)])
        fields = np.random.default_rng(seed).standard_normal(
            (self.NOISE_FIELDS, 32 * 32 * 3), dtype=np.float32)
        fields *= np.float32(noise)
        lo = float(bank.min()) - 4.0 * noise
        scale = 255.0 / (float(bank.max()) + 4.0 * noise - lo)
        self.classes, self.shifts = bank.shape[:2]
        self.confusion = confusion
        self.bank = torch.from_numpy(
            ((bank - lo) * scale).reshape(-1, 32 * 32 * 3))
        self.noise = torch.from_numpy(fields * np.float32(scale))

    def labels(self, rows: int, seed: int) -> np.ndarray:
        """The labels `shard` draws from ``seed``, without the images."""
        r = np.random.default_rng(seed)
        return r.integers(0, self.classes, size=rows).astype(np.int32)

    def shard(self, rows: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(images, labels)`` of ``rows`` images drawn from ``seed``:
        labels first (so `labels` draws them alone), each image its
        class's template at a random shift mixed toward another class's
        by a weight from Uniform(0, ``confusion``), plus a noise field
        from the bank. The draws are numpy's; the sums are gathers and
        elementwise passes on the host, on torch's threads."""
        r = np.random.default_rng(seed)
        labels = r.integers(0, self.classes, size=rows).astype(np.int32)
        other = (labels + r.integers(1, self.classes, size=rows)) \
            % self.classes
        at = r.integers(0, self.shifts, size=rows)
        mix = torch.from_numpy(r.uniform(0.0, self.confusion, size=(rows, 1))
                               .astype(np.float32))
        noise = torch.from_numpy(r.integers(0, len(self.noise), size=rows))
        images = self.bank[torch.from_numpy(labels * self.shifts + at)]
        images.mul_(1.0 - mix)
        images.addcmul_(self.bank[torch.from_numpy(other * self.shifts + at)],
                        mix)
        images.add_(self.noise[noise])
        return images.view(rows, 32, 32, 3).numpy(), labels


def synthetic_cifar_out_of_core(
    count: int,
    shard_rows: int = 8192,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 1.2,
    confusion: float = 0.6,
    device: DeviceLike = "cuda",
):
    """``(images, labels)``: ``count`` CIFAR-shaped training images as an
    `OutOfCoreDataset` whose shard i is drawn when asked for from ``seed
    + i`` (`CifarShards.shard`), on the class templates of
    ``synthetic_cifar(seed=seed)`` and noise fields drawn from ``seed``,
    and their labels as a `Dataset` on ``device`` (drawn alone, a shard
    at a time). Pixel values are not clipped to [0,
    255]: the map leaves 4 noise deviations of room."""
    from .ooc_loader import out_of_core_from_shards

    draws = CifarShards(num_classes, seed, noise, confusion)
    counts = [min(shard_rows, count - lo)
              for lo in range(0, count, shard_rows)]

    def loader(i, rows):
        return lambda: draws.shard(rows, seed + i)[0]

    images = out_of_core_from_shards(
        [loader(i, rows) for i, rows in enumerate(counts)], counts,
        device=device, name="synthetic_cifar")
    labels = np.concatenate([draws.labels(rows, seed + i)
                             for i, rows in enumerate(counts)])
    return images, Dataset(labels, device=device)


def synthetic_cifar(
    n_train: int = 2000,
    n_test: int = 500,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.6,
    confusion: float = 0.0,
    device: DeviceLike = "cuda",
    mesh=None,
) -> Tuple[LabeledData, LabeledData]:
    """A learnable CIFAR-shaped task: each class is a smooth random
    template warped by random shifts + noise; `confusion` > 0 mixes each
    sample's template toward another class's by a weight drawn from
    Uniform(0, confusion). The arrays are made on the host with numpy,
    exactly as the JAX package makes them, then moved to ``device``
    (with ``mesh``, this rank's rows of them: every rank draws the same
    arrays)."""
    device = resolve_device(device)
    templates = cifar_templates(num_classes, seed)

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
            labels=Dataset(labels, device=device, mesh=mesh),
            data=Dataset(images.astype(np.float32), device=device,
                         mesh=mesh),
        )

    return make(n_train, seed + 1), make(n_test, seed + 2)
