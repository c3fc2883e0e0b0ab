"""Device-resident and host-list dataset handles.

Counterpart of `keystone_tpu/data/dataset.py::Dataset` (`:95-276`),
single-device part only, of `HostDataset` (`:278-341`) and of
`zip_datasets` (`:592-610`). The JAX `Dataset` pads its leading axis to a
multiple of the mesh's data shards; with one device and no mesh there is
nothing to pad, so ``padded_count == count`` and ``mask`` is all ones.
Both stay for API parity.

A `HostDataset` is a list of items: host objects (labeled images, numpy
arrays of any shape) or tensors. A batched stage over host items
(`HostDataset.map_batches`) runs through
`utils/batching.py::map_host_batched_stream`: the items are grouped by
shape, each group is stacked onto the device a chunk at a time
(overlapped with the card's work on the previous chunk), and the results
stay on the device as buckets, (item indices, one stacked tensor) a
group: each chunk's rows are written into its group's tensor as they
arrive. The next batched stage takes the buckets whole, chunk by chunk,
so a chain of stages over images of one shape makes one call a stage
and chunk, not one per item, and per-item views exist only when someone
asks for ``items``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.batching import (
    USE_CONFIG_CHUNK,
    _resolve_chunk,
    bucket_by_shape,
    map_host_batched_stream,
)


class Dataset:
    """A tensor whose leading axis is the examples, on one device."""

    is_dataset = True

    def __init__(self, data, count: Optional[int] = None,
                 device: DeviceLike = None):
        """``data``: a tensor or an array. ``device``: where the rows
        live; None keeps a tensor where it is and puts anything else on
        the card."""
        if isinstance(data, torch.Tensor):
            dev = resolve_device(data.device if device is None else device)
            data = data.to(dev)
        else:
            dev = resolve_device(device)
            data = torch.as_tensor(np.asarray(data), device=dev)
        n = data.shape[0]
        self.count = n if count is None else int(count)
        if self.count > n:
            raise ValueError("count exceeds data length")
        self.data = data[: self.count]

    @property
    def array(self) -> torch.Tensor:
        return self.data

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def padded_count(self) -> int:
        return self.data.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the rows: all ones on one device."""
        return torch.ones(self.padded_count, dtype=torch.bool,
                          device=self.device)

    def numpy(self) -> np.ndarray:
        """Host copy (≈ `collect`)."""
        return self.data.detach().cpu().numpy()

    def __len__(self) -> int:
        return self.count

    def map_batches(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    count: Optional[int] = None) -> "Dataset":
        """Apply a whole-batch function to the rows."""
        return self.with_data(fn(self.data), count=count)

    def with_data(self, data: torch.Tensor,
                  count: Optional[int] = None) -> "Dataset":
        """New Dataset over ``data`` with this one's count."""
        return Dataset(data, count=self.count if count is None else count)

    def sync(self) -> "Dataset":
        """Wait until the device has produced the rows (a timing fence)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def cache(self) -> "Dataset":
        """The rows are already materialized on the device (≈ `.cache()`;
        `:228-235`). Not a timing fence: `Cacher` calls it on every run."""
        return self

    @property
    def per_shard_count(self) -> int:
        """Examples a shard (≈ `numPerPartition`, WorkflowUtils.scala:
        12-17; `:150`): one card is one shard."""
        return self.padded_count

    def sample_per_shard(self, k: int, seed: int = 0) -> "Dataset":
        """≤ k rows at evenly spread indices (≈ SampleCollector's
        per-partition samples, NodeOptimizationRule.scala:145-197;
        `:262-267`)."""
        m = min(self.count, k)
        idx = np.linspace(0, self.count - 1, num=m, dtype=np.int64)
        return Dataset(self.data[torch.as_tensor(idx, device=self.device)])

    def take(self, k: int) -> np.ndarray:
        return self.data[: min(k, self.count)].detach().cpu().numpy()

    def __repr__(self) -> str:
        return (f"Dataset(count={self.count}, shape={tuple(self.data.shape)}, "
                f"device={self.device})")


class ZippedDataset(Dataset):
    """N aligned datasets zipped row by row: ``data`` is the tuple of
    their row tensors, in order (the JAX package's `Dataset` over a
    tuple)."""

    def __init__(self, parts: Sequence[torch.Tensor], count: int):
        self.data = tuple(parts)
        self.count = count

    @property
    def device(self) -> torch.device:
        return self.data[0].device

    @property
    def padded_count(self) -> int:
        return self.data[0].shape[0]

    def __repr__(self) -> str:
        shapes = [tuple(p.shape) for p in self.data]
        return (f"ZippedDataset(count={self.count}, shapes={shapes}, "
                f"device={self.device})")


#: one group of a `HostDataset`: the indices of its items, and the
#: items stacked along a new leading axis
Bucket = Tuple[List[int], torch.Tensor]


def _torch_dtype(dtype):
    """A torch dtype from a torch or numpy dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _stack_items(items: Sequence, device: torch.device) -> torch.Tensor:
    """Equal-shape items stacked on ``device``: tensors with
    `torch.stack`, host arrays with `np.stack` and one copy."""
    if isinstance(items[0], torch.Tensor):
        return torch.stack([x.to(device) for x in items])
    return torch.from_numpy(np.stack([np.asarray(x) for x in items])).to(
        device)


class HostDataset:
    """A list of items (≈ an RDD of JVM objects for the non-dense stages:
    labeled images, variable-size images, descriptor matrices).

    ``device`` is where a batched stage stacks host items (None: the
    card); it is resolved only when something is stacked, so a dataset
    of host objects can be made anywhere."""

    is_dataset = True

    def __init__(self, items: Sequence[Any] = (),
                 device: DeviceLike = None):
        self._items: Optional[List[Any]] = list(items)
        self._buckets: Optional[List[Bucket]] = None
        self._count = len(self._items)
        self.device = device

    @classmethod
    def from_buckets(cls, buckets: Sequence[Bucket], count: int,
                     device: DeviceLike = None) -> "HostDataset":
        """A dataset whose items are the rows of ``buckets``' tensors."""
        ds = cls(device=device)
        ds._items, ds._buckets, ds._count = None, list(buckets), count
        return ds

    @property
    def items(self) -> List[Any]:
        if self._items is None:
            out: List[Any] = [None] * self._count
            for idx, stacked in self._buckets:
                for j, i in enumerate(idx):
                    out[i] = stacked[j]
            self._items = out
        return self._items

    @property
    def count(self) -> int:
        return self._count

    def buckets(self) -> List[Bucket]:
        """The items grouped by shape and dtype, in order of first
        appearance, each group stacked on the device."""
        if self._buckets is None:
            dev = resolve_device(self.device)
            self._buckets = [
                (idx, _stack_items([self.items[i] for i in idx], dev))
                for idx in bucket_by_shape(self.items)]
        return self._buckets

    def map(self, fn: Callable) -> "HostDataset":
        """``fn`` on each item."""
        return HostDataset([fn(x) for x in self.items], device=self.device)

    def cache(self) -> "HostDataset":
        return self

    @property
    def per_shard_count(self) -> int:
        """Items a shard (`:292-293`): one card is one shard."""
        return self._count

    def sample_per_shard(self, k: int, seed: int = 0) -> "HostDataset":
        """≤ k items at evenly spread indices (`:301-306`)."""
        m = min(self._count, k)
        if m == 0:
            return HostDataset([], device=self.device)
        idx = np.linspace(0, self._count - 1, num=m, dtype=np.int64)
        return HostDataset([self.items[i] for i in idx], device=self.device)

    def map_batches_stream(self, fn: Callable[[torch.Tensor], torch.Tensor],
                           chunk=USE_CONFIG_CHUNK):
        """``(indices, rows)`` chunks of a batched (leading-axis) function
        over the items: host items through `map_host_batched_stream`,
        items already stacked on the device a slice of their bucket at a
        time. ``chunk``: items a call (default
        ``ExecutionConfig.chunk_size``; None: a bucket at once)."""
        if self._buckets is None:
            return map_host_batched_stream(self.items, fn, chunk,
                                           self.device)
        return self._bucket_chunks(fn, _resolve_chunk(chunk))

    def _bucket_chunks(self, fn, chunk):
        for idx, stacked in self._buckets:
            step = chunk or len(idx)
            for start in range(0, len(idx), step):
                yield idx[start:start + step], fn(stacked[start:start + step])

    def map_batches(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    chunk=USE_CONFIG_CHUNK) -> "HostDataset":
        """`map_batches_stream`, each group's chunks written into one
        tensor on the device as they arrive (a chunk is freed once
        written, so a group's result is held once): the result's
        buckets."""
        groups = (bucket_by_shape(self.items) if self._buckets is None
                  else [list(idx) for idx, _ in self._buckets])
        buckets: List[Bucket] = []
        data, filled = None, 0
        for idx, rows in self.map_batches_stream(fn, chunk):
            group = groups[len(buckets)]
            if list(idx) != group[filled:filled + len(idx)]:
                raise RuntimeError("map_batches: a chunk out of its "
                                   "group's order")
            if data is None:
                data = rows.new_empty((len(group),) + tuple(rows.shape[1:]))
            data[filled:filled + len(idx)] = rows
            filled += len(idx)
            if filled == len(group):
                buckets.append((group, data))
                data, filled = None, 0
        return HostDataset.from_buckets(buckets, self._count, self.device)

    def stack(self, dtype=None) -> Dataset:
        """Equal-shape items as one device `Dataset`, in item order:
        the buckets' tensors, no per-item transfer."""
        if not self._count:
            raise ValueError("stack of an empty HostDataset")
        buckets = self.buckets()
        shapes = {tuple(t.shape[1:]) for _, t in buckets}
        if len(shapes) != 1:
            raise ValueError(f"stack of items of shapes {sorted(shapes)}")
        dtype = _torch_dtype(dtype)
        if dtype is None:   # the dtype np.stack would give
            dtype = buckets[0][1].dtype
            for _, t in buckets[1:]:
                dtype = torch.promote_types(dtype, t.dtype)
        idx, stacked = buckets[0]
        if len(buckets) == 1 and idx == list(range(self._count)):
            return Dataset(stacked.to(dtype))
        data = torch.empty((self._count,) + shapes.pop(), dtype=dtype,
                           device=stacked.device)
        for idx, stacked in buckets:
            data[torch.tensor(idx, device=data.device)] = stacked.to(dtype)
        return Dataset(data)

    def numpy(self) -> List[Any]:
        """The items, tensors copied to the host."""
        return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else x for x in self.items]

    def take(self, k: int) -> List[Any]:
        return self.items[:k]

    def __len__(self) -> int:
        return self._count

    def __iter__(self):
        return iter(self.items)

    def __repr__(self) -> str:
        return f"HostDataset(count={self._count})"


class ZippedHostDataset(HostDataset):
    """N aligned host datasets zipped item by item: each item is the list
    of their items, in order (the JAX package's host `zip_datasets`).
    ``parts`` keeps the datasets, so a batched consumer can take their
    buckets instead of the per-item lists."""

    def __init__(self, parts: Sequence[HostDataset]):
        super().__init__(device=parts[0].device)
        self.parts = list(parts)
        self._items = None
        self._count = min(len(p) for p in self.parts)

    @property
    def items(self) -> List[Any]:
        if self._items is None:
            self._items = [list(t) for t in
                           zip(*(p.items for p in self.parts))]
        return self._items


def zip_datasets(datasets: Sequence):
    """Elementwise zip of N aligned datasets (≈ `RDD.zip`; used by
    gather, GatherTransformerOperator.scala:9-18). Device datasets give a
    `ZippedDataset` (misaligned counts raise); host datasets a
    `ZippedHostDataset` of lists, cut to the shortest, as `zip` is."""
    if not datasets:
        raise ValueError("zip_datasets requires at least one dataset")
    if all(isinstance(d, HostDataset) for d in datasets):
        return ZippedHostDataset(datasets)
    if not all(isinstance(d, Dataset) for d in datasets):
        raise TypeError("zip_datasets requires all-device or all-host "
                        "datasets")
    counts = {d.count for d in datasets}
    if len(counts) != 1:
        raise ValueError(f"zip of misaligned datasets: counts {counts}")
    return ZippedDataset([d.data for d in datasets], datasets[0].count)
