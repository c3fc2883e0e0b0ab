"""Sources drawn a shard at a time, for data larger than the card.

Counterpart of `keystone_tpu/loaders/ooc_loader.py:1-86` (arXiv
1610.09451 §5: pipelines over data far larger than a node's memory).
Each constructor returns a `data/dataset.py::OutOfCoreDataset`: one
loader callback a shard and its row count, nothing loaded up front.
Rows reach the card a window at a time (`utils/batching.py::
stream_spill_windows`); the unified planner decides the window and
whether a cache of them is kept in host memory. ``device`` is where the
windows go: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import glob as _glob
from typing import Callable, Optional, Sequence

import numpy as np

from ..data.dataset import OutOfCoreDataset
from ..device import DeviceLike


def out_of_core_from_shards(
    loaders: Sequence[Callable[[], np.ndarray]],
    counts: Sequence[int],
    device: DeviceLike = "cuda",
    name: str = "ooc",
) -> OutOfCoreDataset:
    """One zero-argument loader a shard and its row count (known up
    front, so neither the window plan nor the planner forces a load)."""
    return OutOfCoreDataset(loaders, counts, device=device, name=name)


def out_of_core_npy_loader(pattern: str, device: DeviceLike = "cuda",
                           name: str = "npy") -> OutOfCoreDataset:
    """The ``.npy`` files matching a glob, sorted by path, a shard each.
    Row counts come from the files' headers (a memory map reads no
    payload page), so building the source reads no data."""
    paths = sorted(_glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no shards match {pattern!r}")
    counts = [int(np.load(p, mmap_mode="r").shape[0]) for p in paths]

    def make_loader(path: str) -> Callable[[], np.ndarray]:
        return lambda: np.load(path)

    return OutOfCoreDataset([make_loader(p) for p in paths], counts,
                            device=device, name=name)


def synthetic_out_of_core(
    count: int,
    dim: int,
    shard_rows: int = 4096,
    dtype=np.float32,
    seed: int = 0,
    device: DeviceLike = "cuda",
    fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> OutOfCoreDataset:
    """A deterministic source for tests and benchmarks: shard i is drawn
    when asked for, with numpy, from ``seed + i`` (two walks see the same
    rows; a load costs the draw, not a disk read). ``fn`` post-processes
    each drawn shard."""
    if count <= 0 or shard_rows <= 0:
        raise ValueError("count and shard_rows must be positive")
    counts = []
    lo = 0
    while lo < count:
        counts.append(min(shard_rows, count - lo))
        lo += counts[-1]

    def make_loader(i: int, rows: int) -> Callable[[], np.ndarray]:
        def load() -> np.ndarray:
            rng = np.random.default_rng(seed + i)
            arr = rng.standard_normal((rows, dim)).astype(dtype)
            return fn(arr) if fn is not None else arr

        return load

    return OutOfCoreDataset(
        [make_loader(i, c) for i, c in enumerate(counts)], counts,
        device=device, name="synthetic")
