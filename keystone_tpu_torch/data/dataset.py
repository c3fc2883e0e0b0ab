"""Device-resident and host-list dataset handles.

Counterpart of `keystone_tpu/data/dataset.py::Dataset` (`:95-276`), of
`HostDataset` (`:278-341`), of the out-of-core tier's `SpilledDataset`
and `OutOfCoreDataset` (`:344-591`) and of `zip_datasets` (`:592-610`).

A `Dataset` placed on a mesh (``mesh=``, `parallel/mesh.py`) follows
JAX's placement along ``data`` (`:100-130, 146-180, 214-230`): the
global count is padded to a multiple of the data shards
(``-(-count // shards) * shards``), this rank holds its contiguous
``per_shard_count`` rows as a plain local tensor (``data``, ``array``),
the padded rows are zeros and ``mask`` marks this rank's valid rows.
Built from a whole array (`from_numpy`, or a tensor every rank holds),
it keeps this rank's slice, so every rank can make the same array from
the same seed, as JAX does. `numpy`, `gather` and `take` all-gather the
rows (a collective: every rank calls them) and drop the padding;
`map_batches` and `with_data` keep the placement. Without a mesh (one
process, the default: the port places rows only where asked) nothing is
padded, ``padded_count == count`` and ``mask`` is all ones.

On a ``(data, model)`` mesh the columns follow JAX's `leaf_sharding`
(`:44-75`): a 2-D leaf whose width the model axis divides is held as
this rank's ``(rows, columns)`` tile (``tiled``; ``width`` is the whole
width, ``spec`` ``P("data", "model")``), and anything else (images,
label vectors, widths the axis does not divide) is model-replicated.
A stage that is not marked ``model_aware`` reads its input after
`gather_model` (`parallel/mesh.py::gather_model_inputs`), and its
output is tiled again by `with_data` (a local slice), as JAX's default
propagation places it; `numpy` and `gather` collect both axes.
`reshard(spec)` (JAX `:214-230`) moves a dataset between ``P("data")``,
``P("data", "model")``, ``P(None, "model")`` and ``P()``: a dataset whose
rows are whole (``mesh`` None) may still be tiled over ``model_mesh``.

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
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    P,
    axis_size,
    data_rank,
    mesh_device,
    model_rank,
    n_data_shards,
    n_model_shards,
    spec_axes,
)
from ..telemetry.instrument import record_dispatch
from ..utils.batching import (
    USE_CONFIG_CHUNK,
    _resolve_chunk,
    bucket_by_shape,
    map_host_batched_stream,
)


def mask_rows(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x`` with the rows ``mask`` marks invalid set to zero."""
    return x * mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))


class Dataset:
    """A tensor whose leading axis is the examples: on one device, or
    this rank's rows of a mesh's ``data`` axis."""

    is_dataset = True

    #: the mesh whose model axis splits the columns held here (None:
    #: every column)
    model_mesh = None

    def __init__(self, data, count: Optional[int] = None,
                 device: DeviceLike = None, mesh=None,
                 placed: bool = False, cols: str = "auto",
                 model_mesh=None):
        """``data``: a tensor or an array. ``device``: where the rows
        live; None keeps a tensor where it is and puts anything else on
        the card (on a mesh: on the mesh's device). ``mesh``: place the
        rows over its data axis; ``data`` is then the whole array, or,
        with ``placed``, already this rank's padded rows of a ``count``
        row array. ``cols``, for a 2-D leaf on a mesh with a model axis
        (``model_mesh``, default ``mesh``): "auto" tiles it where the
        model axis divides its width (JAX's placement), "full" keeps
        every column, "tile" says ``data`` is already this rank's
        tile."""
        self.mesh = mesh
        model_mesh = model_mesh if model_mesh is not None else mesh
        if model_mesh is not None and device is None and not isinstance(
                data, torch.Tensor):
            device = mesh_device(model_mesh)
        if mesh is not None and not placed:
            data = self._local_slice(data, count, mesh)
            count = data[1]
            data = data[0]
        self.model_mesh = None
        m = n_model_shards(model_mesh) if model_mesh is not None else 1
        if m > 1 and len(data.shape) == 2:
            if cols == "tile":
                self.model_mesh = model_mesh
            elif cols == "auto" and data.shape[1] % m == 0:
                w = data.shape[1] // m
                lo = model_rank(model_mesh) * w
                data = data[:, lo:lo + w]
                self.model_mesh = model_mesh
        if isinstance(data, torch.Tensor):
            dev = resolve_device(data.device if device is None else device)
            data = data.to(dev)
        else:
            dev = resolve_device(device)
            data = torch.as_tensor(np.ascontiguousarray(data), device=dev)
        if self.model_mesh is not None:
            data = data.contiguous()
        n = data.shape[0]
        if mesh is not None:
            shards = n_data_shards(mesh)
            self.count = n * shards if count is None else int(count)
            if -(-self.count // shards) * shards != n * shards:
                raise ValueError(
                    f"{n} rows a shard do not hold {self.count} rows "
                    f"padded over {shards} shards")
            self.data = data
            return
        self.count = n if count is None else int(count)
        if self.count > n:
            raise ValueError("count exceeds data length")
        self.data = data[: self.count]

    @staticmethod
    def _local_slice(data, count, mesh):
        """(this rank's padded rows of the whole ``data``, count): sliced
        before any copy, so a host array moves only this rank's rows."""
        n = data.shape[0]
        count = n if count is None else int(count)
        if count > n:
            raise ValueError("count exceeds data length")
        shards = n_data_shards(mesh)
        per = -(-count // shards) if count else 1
        lo = min(data_rank(mesh) * per, count)
        hi = min(lo + per, count)
        rows = data[lo:hi]
        if hi - lo < per:
            pad = (per - (hi - lo),) + tuple(rows.shape[1:])
            if isinstance(rows, torch.Tensor):
                rows = torch.cat([rows, rows.new_zeros(pad)])
            else:
                rows = np.asarray(rows)
                rows = np.concatenate([rows, np.zeros(pad, rows.dtype)])
        return rows, count

    @staticmethod
    def from_numpy(x, count: Optional[int] = None, mesh=None) -> "Dataset":
        """A dataset of the host array ``x`` (on a mesh: this rank's rows
        of it)."""
        return Dataset(np.asarray(x), count=count, mesh=mesh)

    @property
    def array(self) -> torch.Tensor:
        return self.data

    @property
    def tiled(self) -> bool:
        """Whether the rows held here are this rank's column tile."""
        return self.model_mesh is not None

    @property
    def width(self) -> int:
        """Columns of the whole dataset (a tile's times the model
        shards)."""
        w = int(self.data.shape[1])
        return w * n_model_shards(self.model_mesh) if self.tiled else w

    @property
    def col_start(self) -> int:
        """Global index of the first column held here."""
        if not self.tiled:
            return 0
        return model_rank(self.model_mesh) * int(self.data.shape[1])

    @property
    def spec(self):
        """The placement, as a batch-level `PartitionSpec`: the rows
        over ``data`` (or whole), the columns of a tile over
        ``model``."""
        rows = DATA_AXIS if self.mesh is not None else None
        if self.tiled:
            return P(rows, MODEL_AXIS)
        return P(rows) if rows is not None else P()

    def gather_model(self) -> "Dataset":
        """This dataset with every column on every rank of the model
        axis, its rows as they are: one ``all_gather`` over ``model``.
        A dataset that is not tiled is returned as it is."""
        if not self.tiled:
            return self
        from ..parallel.collectives import all_gather_columns

        full = all_gather_columns(self.data, self.model_mesh)
        return Dataset(full, count=self.count, mesh=self.mesh,
                       placed=True, cols="full")

    def reshard(self, spec, mesh=None) -> "Dataset":
        """This dataset moved to ``spec`` (JAX `:214-230`), one of
        ``P("data")``, ``P("data", "model")``, ``P(None, "model")`` and
        ``P()``, over ``mesh`` (default: its own). Columns are gathered
        over ``model`` and rows over ``data`` where the target holds
        more of them, and sliced locally where it holds fewer; a
        dataset already laid out as ``spec`` is returned as it is (the
        identity short-circuit: no collective)."""
        entries = tuple(spec) + (None, None)
        rows_target = DATA_AXIS in spec_axes((entries[0],))
        cols_target = MODEL_AXIS in spec_axes((entries[1],))
        mesh = mesh if mesh is not None else (
            self.mesh if self.mesh is not None else self.model_mesh)
        if mesh is None:
            from ..parallel.mesh import current_mesh

            mesh = current_mesh()
            if mesh is None:  # one process: one layout
                return self
        if self.data.dim() != 2 or n_model_shards(mesh) <= 1 or (
                cols_target and self.data.shape[1] % n_model_shards(mesh)
                and not self.tiled):
            cols_target = False
        if rows_target == (self.mesh is not None) \
                and cols_target == self.tiled:
            return self
        out = self
        if out.tiled and not cols_target:
            out = out.gather_model()
        if out.mesh is not None and not rows_target:
            from ..parallel.collectives import all_gather_rows

            out = Dataset(all_gather_rows(out.data, out.mesh)[: out.count],
                          count=out.count, model_mesh=out.model_mesh,
                          cols="tile" if out.tiled else "full")
        x = out.data
        if out.tiled:  # rows move below with the tile's columns
            cols = "tile"
        else:
            cols = "auto" if cols_target else "full"
        if rows_target and out.mesh is None:
            return Dataset(x[: out.count], count=out.count, mesh=mesh,
                           cols=cols)
        return Dataset(x, count=out.count, mesh=out.mesh,
                       placed=out.mesh is not None, cols=cols,
                       model_mesh=mesh)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def _rows(self) -> int:
        """Rows held here (this rank's, padding included)."""
        return self.data[0].shape[0] if isinstance(self.data, tuple) \
            else self.data.shape[0]

    @property
    def n_shards(self) -> int:
        return n_data_shards(self.mesh) if self.mesh is not None else 1

    @property
    def padded_count(self) -> int:
        return self._rows * self.n_shards

    @property
    def _first_row(self) -> int:
        """Global index of this rank's first row."""
        return data_rank(self.mesh) * self._rows if self.mesh is not None \
            else 0

    @property
    def has_padding(self) -> bool:
        """Whether rows held here include padded ones."""
        return self._first_row + self._rows > self.count

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the rows held here: all ones on one
        device; on a mesh, False on this rank's padded rows."""
        if not self.has_padding:
            return torch.ones(self._rows, dtype=torch.bool,
                              device=self.device)
        valid = self.count - self._first_row
        return torch.arange(self._rows, device=self.device) < valid

    def gather(self) -> torch.Tensor:
        """The ``count`` rows of the whole dataset on this device (≈
        `collect` to every executor); on a mesh, one all-gather a mesh
        axis it is split over."""
        data = self.gather_model().data if self.tiled else self.data
        if self.mesh is None:
            return data
        from ..parallel.collectives import all_gather_rows

        return all_gather_rows(data, self.mesh)[: self.count]

    def numpy(self) -> np.ndarray:
        """Host copy (≈ `collect`)."""
        return self.gather().detach().cpu().numpy()

    def __len__(self) -> int:
        return self.count

    def map_batches(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    count: Optional[int] = None) -> "Dataset":
        """Apply a whole-batch function to the rows held here: one
        batched call, counted in ``dispatch.programs_executed``
        (`:195-203`)."""
        record_dispatch()
        return self.with_data(fn(self.data), count=count)

    def with_data(self, data: torch.Tensor,
                  count: Optional[int] = None, cols: Optional[str] = None,
                  spec=None) -> "Dataset":
        """New Dataset over ``data`` (rows in this one's placement) with
        this one's count. ``cols`` as in `Dataset`; None: "tile" where
        this one is tiled and ``data`` has its tile's width (a stage
        that ran on the tile), else "auto" (full columns, tiled as JAX
        places a stage's output). ``spec``: the placement a planner
        chose for the result (`reshard`)."""
        count = self.count if count is None else count
        if cols is None:
            cols = "tile" if (self.tiled and data.dim() == 2
                              and data.shape[1] == self.data.shape[1]) \
                else "auto"
        if spec is not None and cols == "auto":
            cols = "full"
        if self.mesh is not None:
            out = Dataset(data, count=count, mesh=self.mesh, placed=True,
                          cols=cols, model_mesh=self.model_mesh)
        else:
            out = Dataset(data, count=count, cols=cols,
                          model_mesh=self.model_mesh)
        return out.reshard(spec) if spec is not None else out

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
        12-17; `:150`): the rows a rank holds; one card is one shard."""
        return self._rows

    def sample_per_shard(self, k: int, seed: int = 0) -> "Dataset":
        """≤ k rows a shard at evenly spread global indices (≈
        SampleCollector's per-partition samples,
        NodeOptimizationRule.scala:145-197; `:262-267`); on a mesh the
        same rows on every rank (each rank's rows of the sample, summed
        by one all-reduce), as one process's `Dataset`."""
        if self.tiled:
            return self.gather_model().sample_per_shard(k, seed)
        m = min(self.count, k * self.n_shards)
        idx = np.linspace(0, self.count - 1, num=m, dtype=np.int64)
        if self.mesh is None:
            return Dataset(self.data[torch.as_tensor(idx,
                                                     device=self.device)])
        from ..parallel.collectives import all_reduce

        lo = self._first_row
        mine = np.nonzero((idx >= lo) & (idx < lo + self._rows))[0]
        out = self.data.new_zeros((m,) + tuple(self.data.shape[1:]))
        out[torch.as_tensor(mine, device=self.device)] = self.data[
            torch.as_tensor(idx[mine] - lo, device=self.device)]
        return Dataset(all_reduce(out, self.mesh))

    def take(self, k: int) -> np.ndarray:
        if self.mesh is not None or self.tiled:
            return self.numpy()[:k]
        return self.data[: min(k, self.count)].detach().cpu().numpy()

    def __repr__(self) -> str:
        shards = f", shards={self.n_shards}" if self.mesh is not None else ""
        if self.tiled:
            shards += f", tile of {self.width} columns"
        return (f"Dataset(count={self.count}, shape={tuple(self.data.shape)}, "
                f"device={self.device}{shards})")


class ZippedDataset(Dataset):
    """N aligned datasets zipped row by row: ``data`` is the tuple of
    their row tensors, in order (the JAX package's `Dataset` over a
    tuple)."""

    def __init__(self, parts: Sequence[torch.Tensor], count: int,
                 mesh=None):
        self.data = tuple(parts)
        self.count = count
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.data[0].device

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
    of host objects can be made anywhere.

    On a mesh (`on_mesh`) the items are this rank's contiguous share of
    ``total`` items, ``ceil(total / shards)`` a rank as `Dataset` places
    rows, none padded: ``count`` and ``len`` are this rank's items,
    `stack` places the rows over the mesh, and a stage's output keeps
    the placement (`keep_host_placement`)."""

    is_dataset = True

    #: the mesh whose data axis holds these items (None: every item)
    mesh = None

    def __init__(self, items: Sequence[Any] = (),
                 device: DeviceLike = None):
        self._items: Optional[List[Any]] = list(items)
        self._buckets: Optional[List[Bucket]] = None
        self._count = len(self._items)
        self.device = device
        self._total = 0

    @property
    def total(self) -> int:
        """Items over every rank (this rank's without a mesh)."""
        return self._total if self.mesh is not None else self._count

    @classmethod
    def on_mesh(cls, items: Sequence[Any], mesh,
                device: DeviceLike = None) -> "HostDataset":
        """This rank's share of ``items`` (every rank passes all of
        them, in one order) over ``mesh``'s data axis; with one data
        shard, all of them."""
        items = list(items)
        shards = axis_size(mesh, DATA_AXIS)
        if shards == 1:
            return cls(items, device=device)
        per = -(-len(items) // shards)
        lo = min(data_rank(mesh) * per, len(items))
        out = cls(items[lo:lo + per], device=device)
        out.mesh, out._total = mesh, len(items)
        return out

    def placed_like(self, other: "HostDataset") -> "HostDataset":
        """This dataset with ``other``'s placement (its rank's rows)."""
        self.mesh, self._total = other.mesh, other.total
        return self

    def gather_items(self) -> List[Any]:
        """Every rank's items in global order, on every rank. Without a
        mesh, the items."""
        if self.mesh is None:
            return list(self.items)
        return _gather_items(self.items, self.mesh)

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
        return HostDataset([fn(x) for x in self.items],
                           device=self.device).placed_like(self)

    def cache(self) -> "HostDataset":
        return self

    @property
    def per_shard_count(self) -> int:
        """Items a shard (`:292-293`): one card is one shard; on a mesh,
        every rank's share, ``ceil(total / shards)``."""
        if self.mesh is None:
            return self._count
        return -(-self.total // n_data_shards(self.mesh))

    def sample_per_shard(self, k: int, seed: int = 0) -> "HostDataset":
        """≤ k items a shard at evenly spread indices (`:301-306`); on a
        mesh the same items on every rank, one process's sample of
        ``k · shards`` items (each rank's picks gathered), not placed."""
        shards = n_data_shards(self.mesh) if self.mesh is not None else 1
        m = min(self.total, k * shards)
        if m == 0:
            return HostDataset([], device=self.device)
        idx = np.linspace(0, self.total - 1, num=m, dtype=np.int64)
        if self.mesh is None:
            return HostDataset([self.items[i] for i in idx],
                               device=self.device)
        lo = data_rank(self.mesh) * self.per_shard_count
        return HostDataset(_gather_items(
            [self.items[i - lo] for i in idx if lo <= i < lo + self._count],
            self.mesh), device=self.device)

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
        return HostDataset.from_buckets(buckets, self._count,
                                        self.device).placed_like(self)

    def stack(self, dtype=None) -> Dataset:
        """Equal-shape items as one device `Dataset`, in item order:
        the buckets' tensors, no per-item transfer. On a mesh, this
        rank's rows of the placed `Dataset` (zero rows pad the share)."""
        data = self._stack(dtype)
        if self.mesh is None:
            return data
        per = self.per_shard_count
        rows = data.array
        if rows.shape[0] < per:
            rows = torch.cat([rows, rows.new_zeros(
                (per - rows.shape[0],) + tuple(rows.shape[1:]))])
        return Dataset(rows, count=self.total, mesh=self.mesh, placed=True)

    def _stack(self, dtype=None) -> Dataset:
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
        """The first ``k`` items; on a mesh, of the global order, on
        every rank (each rank's part of them gathered)."""
        if self.mesh is None:
            return self.items[:k]
        lo = data_rank(self.mesh) * self.per_shard_count
        return _gather_items(self.items[:max(0, k - lo)], self.mesh)

    def __len__(self) -> int:
        return self._count

    def __iter__(self):
        return iter(self.items)

    def __repr__(self) -> str:
        shards = (f", total={self.total}, shards="
                  f"{n_data_shards(self.mesh)}" if self.mesh is not None
                  else "")
        return f"HostDataset(count={self._count}{shards})"


def _gather_items(items: Sequence[Any], mesh) -> List[Any]:
    """Every rank's ``items`` in rank order, on every rank of ``mesh``'s
    data axis: one counted ``all_gather_object`` (tensors travel through
    the host; `parallel.all_gather_objects`)."""
    from ..parallel.collectives import all_gather_objects

    mine = [x.cpu() if isinstance(x, torch.Tensor) else x for x in items]
    return [x for part in all_gather_objects(mine, mesh) for x in part]


def keep_host_placement(out, inputs):
    """``out``, a stage's output: where it is a `HostDataset` with no
    placement and as many items as a `HostDataset` of ``inputs`` placed
    on a mesh (a dataset, or a list of them), it takes that one's
    placement (a stage that builds its output afresh keeps its rank's
    rows)."""
    if not isinstance(out, HostDataset) or out.mesh is not None:
        return out
    for x in inputs if isinstance(inputs, (list, tuple)) else (inputs,):
        if isinstance(x, (list, tuple)):
            out = keep_host_placement(out, x)
        elif isinstance(x, HostDataset) and x.mesh is not None \
                and len(x) == len(out):
            return out.placed_like(x)
    return out


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
        if parts[0].mesh is not None:
            self.placed_like(parts[0])

    @property
    def items(self) -> List[Any]:
        if self._items is None:
            self._items = [list(t) for t in
                           zip(*(p.items for p in self.parts))]
        return self._items


def _leaves(tree) -> list:
    return list(tree) if isinstance(tree, tuple) else [tree]


def _tree_map(fn, tree):
    return tuple(fn(x) for x in tree) if isinstance(tree, tuple) else fn(tree)


def _host_tensor(x) -> torch.Tensor:
    """A host array or tensor as a CPU tensor (no copy where it is one)."""
    if isinstance(x, torch.Tensor):
        return x if x.device.type == "cpu" else x.cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def _device_dataset(host, count: int, device) -> Dataset:
    """Host rows (a tensor, an array, or a tuple of them) as a `Dataset`
    on ``device``."""
    leaves = [_host_tensor(x).to(device) for x in _leaves(host)]
    if len(leaves) == 1:
        return Dataset(leaves[0], count=count)
    return ZippedDataset(leaves, count)


class SpilledDataset:
    """A dataset held in host memory: the out-of-core tier's cache
    payload (`keystone_tpu/data/dataset.py:344-463`).

    A host-placed `workflow/autocache.py::CacheMarker` copies its input
    off the card into one of these, in pinned host memory where a card is
    present (``spill.bytes_out``). Consumers take it back in windows
    (`window_iter`: bounded row windows on the pad ladder, each reload
    overlapped with the previous window's work through the pinned ring
    and copy stream of `utils/batching.py`) or whole (`rehydrate`,
    ``spill.bytes_in``). Like JAX's, it exposes neither ``data`` nor
    ``items``, so the telemetry's byte estimate counts nothing of it
    against the card. ``device`` is where its rows go back to."""

    is_dataset = True
    is_spilled = True

    def __init__(self, host_data, count: Optional[int] = None,
                 device: DeviceLike = None, name: str = ""):
        leaves = [_host_tensor(x) for x in _leaves(host_data)]
        if not leaves:
            raise ValueError("SpilledDataset requires at least one array")
        n = int(leaves[0].shape[0])
        self.count = int(count) if count is not None else n
        if self.count > n:
            raise ValueError("count exceeds data length")
        self.device = resolve_device(device)
        self.name = name
        # the true rows only: a reload never uploads padding
        host = [x[: self.count] for x in leaves]
        self._host = tuple(host) if isinstance(host_data, tuple) else host[0]

    @staticmethod
    def spill(dataset, name: str = "") -> "SpilledDataset":
        """A device `Dataset` (or a `HostDataset` of device buckets)
        copied to host memory, pinned where the rows are on a card:
        the device-to-host spill, counted in ``spill.bytes_out``."""
        from ..telemetry.metrics import counter

        if isinstance(dataset, HostDataset):
            dataset = dataset.stack()
        parts = (dataset.data if isinstance(dataset.data, tuple)
                 else (dataset.data,))
        host = []
        for x in parts:
            x = x[: dataset.count]
            if x.device.type == "cuda":
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x)
                host.append(buf)
            else:
                host.append(x.clone())
        counter("spill.bytes_out").inc(float(sum(
            h.numel() * h.element_size() for h in host)))
        data = tuple(host) if isinstance(dataset.data, tuple) else host[0]
        return SpilledDataset(data, count=dataset.count,
                              device=dataset.device, name=name)

    @property
    def nbytes(self) -> int:
        return int(sum(x.numel() * x.element_size()
                       for x in _leaves(self._host)))

    @property
    def item_shape(self) -> tuple:
        return tuple(_leaves(self._host)[0].shape[1:])

    def row_loader(self, lo: int, hi: int):
        """Host rows [lo, hi): what the windowed reload stages."""
        return _tree_map(lambda x: x[lo:hi], self._host)

    def window_iter(self, window=USE_CONFIG_CHUNK):
        """``(indices, device_window)`` pairs, a window's rows on the
        card at a time (`utils/batching.py::stream_spill_windows`)."""
        from ..utils.batching import stream_spill_windows

        return stream_spill_windows(self.row_loader, self.count, window,
                                    device=self.device)

    def rehydrate(self) -> Dataset:
        """The whole value back on its device, counted in
        ``spill.bytes_in``; consumers that take windows use
        `window_iter`."""
        from ..telemetry.metrics import counter

        counter("spill.bytes_in").inc(float(self.nbytes))
        return _device_dataset(self._host, self.count, self.device)

    def numpy(self):
        return _tree_map(lambda x: x.numpy(), self._host)

    def take(self, k: int):
        return _tree_map(lambda x: x[: min(k, self.count)].numpy(),
                         self._host)

    @property
    def per_shard_count(self) -> int:
        return self.count  # one card is one shard

    def sample_per_shard(self, k: int, seed: int = 0) -> Dataset:
        m = min(self.count, k)
        idx = torch.as_tensor(
            np.linspace(0, self.count - 1, num=m, dtype=np.int64))
        return _device_dataset(_tree_map(lambda x: x[idx], self._host), m,
                               self.device)

    def cache(self) -> "SpilledDataset":
        return self  # materialized already, in host memory

    def sync(self) -> "SpilledDataset":
        return self

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"SpilledDataset(count={self.count}, "
                f"host_bytes={self.nbytes})")


class OutOfCoreDataset:
    """A source drawn a shard at a time, for data larger than the card
    (`keystone_tpu/data/dataset.py:466-591`, arXiv 1610.09451 §5).

    ``loaders[i]()`` returns shard i's host rows (an array or a tuple of
    them) with ``counts[i]`` rows; nothing loads until a window asks.
    Rows reach the card a window at a time (`window_iter`,
    `map_windowed`), so the card holds O(window) of them; one loaded
    shard is kept (the walk is sequential). `materialize` is the whole
    source on the card, for runs that are not constrained. ``device``:
    where windows go (None: the card)."""

    is_dataset = True
    is_out_of_core = True

    def __init__(self, loaders: Sequence[Callable[[], Any]],
                 counts: Sequence[int], device: DeviceLike = None,
                 name: str = "ooc"):
        if not loaders:
            raise ValueError("OutOfCoreDataset requires at least one shard")
        if len(loaders) != len(counts):
            raise ValueError("one count per shard loader required")
        self._loaders = list(loaders)
        self._counts = [int(c) for c in counts]
        if any(c <= 0 for c in self._counts):
            raise ValueError("shard counts must be positive")
        self._offsets = np.concatenate(([0], np.cumsum(self._counts)))
        self.count = int(self._offsets[-1])
        self.device = resolve_device(device)
        self.name = name
        self._hot: Tuple[Optional[int], Any] = (None, None)

    def _shard(self, i: int):
        """Shard i's host rows, through the one-shard cache."""
        hot_i, hot_v = self._hot
        if hot_i != i:
            hot_v = self._loaders[i]()
            n = _leaves(hot_v)[0].shape[0]
            if int(n) != self._counts[i]:
                raise ValueError(f"shard {i} loader returned {n} rows, "
                                 f"declared {self._counts[i]}")
            self._hot = (i, hot_v)
        return hot_v

    def row_loader(self, lo: int, hi: int):
        """Host rows [lo, hi), joined across the shards the range
        overlaps: the windowed reload's ``load``."""
        if not (0 <= lo <= hi <= self.count):
            raise IndexError(f"rows [{lo}, {hi}) out of range")
        first = int(np.searchsorted(self._offsets, lo, side="right")) - 1
        pieces = []
        i = first
        while i < len(self._loaders) and int(self._offsets[i]) < hi:
            base = int(self._offsets[i])
            a, b = max(lo - base, 0), min(hi - base, self._counts[i])
            pieces.append(_tree_map(lambda x, a=a, b=b: x[a:b],
                                    self._shard(i)))
            i += 1
        if len(pieces) == 1:
            return pieces[0]
        if isinstance(pieces[0], tuple):
            return tuple(np.concatenate([p[k] for p in pieces])
                         for k in range(len(pieces[0])))
        return np.concatenate(pieces)

    def gather(self, indices) -> Any:
        """Host rows at ``indices`` (any order), each shard loaded once."""
        idx = np.asarray(indices, dtype=np.int64)
        order = np.argsort(idx, kind="stable")
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        first = _leaves(self._shard(int(shard_of[order[0]])))
        out = [np.empty((len(idx),) + tuple(x.shape[1:]), dtype=x.dtype)
               for x in first]
        for i in np.unique(shard_of):
            rows = np.nonzero(shard_of == i)[0]
            shard = _leaves(self._shard(int(i)))
            for o, x in zip(out, shard):
                o[rows] = np.asarray(x)[idx[rows] - self._offsets[i]]
        return tuple(out) if len(out) > 1 else out[0]

    @property
    def nbytes(self) -> int:
        """Host bytes of the whole source, from shard 0's bytes a row."""
        per_row = sum(x.nbytes / max(1, x.shape[0])
                      for x in _leaves(self._shard(0)))
        return int(per_row * self.count)

    @property
    def item_shape(self) -> tuple:
        return tuple(_leaves(self._shard(0))[0].shape[1:])

    def window_iter(self, window=USE_CONFIG_CHUNK):
        from ..utils.batching import stream_spill_windows

        return stream_spill_windows(self.row_loader, self.count, window,
                                    device=self.device)

    def map_windowed(self, fn: Callable, window=USE_CONFIG_CHUNK):
        """``(indices, rows)`` chunks of ``fn`` over the windows on the
        card (`utils/batching.py::map_spill_windows`)."""
        from ..utils.batching import map_spill_windows

        return map_spill_windows(self.row_loader, self.count, fn, window,
                                 device=self.device)

    def materialize(self) -> Dataset:
        """The whole source on its device, counted in
        ``spill.bytes_in``."""
        from ..telemetry.metrics import counter

        host = self.row_loader(0, self.count)
        counter("spill.bytes_in").inc(float(sum(
            np.asarray(x).nbytes for x in _leaves(host))))
        return _device_dataset(host, self.count, self.device)

    def spill(self, name: str = "") -> SpilledDataset:
        """The whole source in host memory as a `SpilledDataset`, with no
        trip through the card."""
        return SpilledDataset(self.row_loader(0, self.count),
                              count=self.count, device=self.device,
                              name=name or self.name)

    def numpy(self):
        return self.row_loader(0, self.count)

    def take(self, k: int):
        return self.row_loader(0, min(k, self.count))

    @property
    def per_shard_count(self) -> int:
        return self.count  # one card is one shard

    def sample_per_shard(self, k: int, seed: int = 0) -> Dataset:
        m = min(self.count, k)
        idx = np.linspace(0, self.count - 1, num=m, dtype=np.int64)
        return _device_dataset(self.gather(idx), m, self.device)

    def cache(self) -> "OutOfCoreDataset":
        return self  # caching it is the planner's decision

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"OutOfCoreDataset(count={self.count}, "
                f"shards={len(self._loaders)})")


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
    if any(d.mesh != datasets[0].mesh for d in datasets):
        raise ValueError("zip of datasets placed on different meshes")
    return ZippedDataset([d.data for d in datasets], datasets[0].count,
                         datasets[0].mesh)
