"""Host CSR dataset, with its CSR copied to a device once.

Counterpart of `keystone_tpu/data/sparse.py::SparseDataset` (`:21-76`;
reference nodes/util/Sparsify.scala keeps Breeze SparseVectors on the
JVM). The rows are examples, held on the host as a scipy CSR matrix. The
JAX package densifies it before any device work (`:1-8`: TPUs have no
efficient sparse GEMM). On the card the CSR itself is the device form:
`csr` copies its three arrays to ``device`` once, as a
`torch.sparse_csr_tensor`, and the products run on it (cuSPARSE SpMM on
CUDA, through ``csr @ dense``). A product with Xᵀ needs the CSR of Xᵀ,
which scipy builds on the host once (`csr_t`): a transposed CSR is a CSC
matrix to torch, and its product is another call on CUDA.

`padded_form_ok`, `pad_csr` and `PaddedSparseDataset` (`:79-249`) hold
the width-padded form: each row's nonzeros in ``w`` slots, the unused
slots carrying the sentinel column ``dim`` and the value 0, with an
optional column form (the same padding of Xᵀ, sentinel row ``count``).
JAX lays it out slot-major, (w, n), and rounds w up to 8 sublanes
(`sublane_pad8`), because the TPU's (8, 128) tiles pad a narrow minor
axis to 128 lanes. The card's memory has no tiles, so the port keeps
ELL rows, (n, w) row-major: a row's slots are contiguous, as cuSPARSE's
CSR wants them, and the padded arrays are the CSR arrays of an
(n, dim + 1) matrix whose last column is the sentinel (`csr`), with row
pointers ``w`` apart. The size caps are JAX's shares of its 16 GB chip
taken of the device's memory (`memory_budget`).

On a mesh (``mesh=``; JAX's ``mesh`` attribute, `:26-28, 147-153`) each
dataset holds this rank's contiguous rows of the ``data`` axis, placed
as `HostDataset.on_mesh` places items (``ceil(total / shards)`` a rank,
none padded): ``count`` and ``len`` are this rank's rows, ``total`` every
rank's, ``per_shard_count`` and `sample_per_shard` as `HostDataset`'s
(JAX `:44-47, 56-61`; the sample the same rows on every rank, one
process's). Built from the whole CSR (every rank passes it) a dataset
keeps its rank's rows; `SparseFeatureVectorizer` builds one from a
rank's rows (``total`` given). `numpy` and `gather` return the whole
CSR in global order, `densify` a `Dataset` placed on the same mesh, and
`map_rows` keeps the placement. `PaddedSparseDataset.from_csr(...,
mesh=)` pads every rank to the widest row over all ranks, one
process's slot count. A mesh of one data shard places nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import DATA_AXIS, axis_size, data_rank
from .dataset import Dataset

#: bytes the CPU stands for when a size is a share of device memory
CPU_MEMORY_BUDGET = 16 * 2**30
#: the padded form's share of the device: the share JAX's cap takes of
#: its 16 GB chip (`:86-98`), room left for the column form and solver
#: transients
PADDED_SHARE = 5.0 / 16.0


def memory_budget(device: DeviceLike = "cuda") -> float:
    """Bytes of ``device``: the card's total memory, or
    `CPU_MEMORY_BUDGET` on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return float(CPU_MEMORY_BUDGET)


def _to_torch_csr(m: sp.csr_matrix, device: torch.device) -> torch.Tensor:
    """``m``'s index and value arrays copied to ``device`` once each."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr).to(device),
        torch.from_numpy(m.indices).to(device),
        torch.from_numpy(m.data.astype(np.float32, copy=False)).to(device),
        size=m.shape, check_invariants=False)


def _placement(mesh, total: int):
    """(mesh or None, rows a rank, this rank's first row) for ``total``
    rows over ``mesh``'s data axis; None where it has one shard."""
    shards = axis_size(mesh, DATA_AXIS)
    if shards == 1:
        return None, total, 0
    per = -(-total // shards)
    return mesh, per, min(data_rank(mesh) * per, total)


class _Placed:
    """The row placement `SparseDataset` and `PaddedSparseDataset`
    share: ``mesh``, ``total`` and ``first_row``, set by `_place`."""

    mesh = None
    total = 0
    first_row = 0

    def _place(self, mesh, total: int) -> None:
        self.mesh, per, self.first_row = _placement(mesh, total)
        self.total = total if self.mesh is not None else self.count

    @property
    def per_shard_count(self) -> int:
        """Rows a shard: one card is one shard; on a mesh, every rank's
        share, ``ceil(total / shards)``."""
        if self.mesh is None:
            return self.count
        return -(-self.total // axis_size(self.mesh, DATA_AXIS))

    def rows_dataset(self, rows: torch.Tensor) -> Dataset:
        """A tensor of this rank's rows (one a row held here) as a
        `Dataset` in this placement: on a mesh, padded with zero rows to
        ``per_shard_count`` and placed over ``total`` rows."""
        if self.mesh is None:
            return Dataset(rows)
        pad = self.per_shard_count - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_zeros(
                (pad,) + tuple(rows.shape[1:]))])
        return Dataset(rows, count=self.total, mesh=self.mesh, placed=True)

    def local_rows(self, x):
        """The rows of ``x`` aligned with the rows held here: a `Dataset`
        placed alike (its padding dropped), or a whole array or tensor
        every rank holds (this rank's slice)."""
        if isinstance(x, Dataset):
            return x.array[:self.count]
        if self.mesh is not None and len(x) == self.total:
            return x[self.first_row:self.first_row + self.count]
        return x


def _whole_rows(matrix, mesh, total: Optional[int]):
    """(this rank's rows of ``matrix``, the global row count): with
    ``total`` None ``matrix`` is the whole CSR and is sliced, else it is
    already this rank's rows."""
    if total is not None:
        return matrix, int(total)
    total = matrix.shape[0]
    mesh, per, lo = _placement(mesh, total)
    return (matrix[lo:lo + per] if mesh is not None else matrix), total


class SparseDataset(_Placed):
    """A CSR matrix of examples (rows) on the host. ``device`` is where
    its device forms go (None: the card), resolved only when one is
    made. ``mesh``: place the rows over its data axis; ``matrix`` is then
    the whole CSR, or, with ``total``, this rank's rows of a
    ``total``-row CSR."""

    is_dataset = True

    def __init__(self, matrix, device: DeviceLike = None, mesh=None,
                 total: Optional[int] = None):
        matrix, total = _whole_rows(sp.csr_matrix(matrix), mesh, total)
        self.matrix = matrix
        self.device = device
        self._place(mesh, total)
        self._csr: Optional[torch.Tensor] = None
        self._csr_t: Optional[torch.Tensor] = None
        self._total_nnz: Optional[int] = None

    def _like(self, matrix) -> "SparseDataset":
        """A dataset of ``matrix``, rows in this one's placement."""
        return SparseDataset(matrix, device=self.device, mesh=self.mesh,
                             total=self.total if self.mesh is not None
                             else None)

    @property
    def count(self) -> int:
        """Rows held here (this rank's on a mesh)."""
        return self.matrix.shape[0]

    @property
    def dim(self) -> int:
        return self.matrix.shape[1]

    @property
    def nnz(self) -> int:
        """Nonzeros held here."""
        return self.matrix.nnz

    @property
    def total_nnz(self) -> int:
        """Nonzeros over every rank: on a mesh one collective at first
        read, which every rank makes."""
        if self._total_nnz is None:
            from ..parallel.collectives import all_gather_objects

            self._total_nnz = sum(all_gather_objects(self.nnz, self.mesh))
        return self._total_nnz

    @property
    def sparsity(self) -> float:
        """Fraction of nonzeros, over every rank's rows."""
        return self.total_nnz / max(self.total * self.dim, 1)

    def csr(self) -> torch.Tensor:
        """The (count, dim) CSR on ``device``, copied at first use."""
        if self._csr is None:
            self._csr = _to_torch_csr(self.matrix,
                                      resolve_device(self.device))
        return self._csr

    def csr_t(self) -> torch.Tensor:
        """The (dim, count) CSR of Xᵀ on ``device``, built by scipy on
        the host and copied at first use."""
        if self._csr_t is None:
            self._csr_t = _to_torch_csr(self.matrix.T.tocsr(),
                                        resolve_device(self.device))
        return self._csr_t

    def map_rows(self, fn) -> "SparseDataset":
        return self._like(fn(self.matrix))

    def densify(self, dtype=np.float32) -> Dataset:
        """The rows as a dense device `Dataset`, on a mesh placed on
        it."""
        return self.rows_dataset(torch.as_tensor(
            np.asarray(self.matrix.todense(), dtype=dtype),
            device=resolve_device(self.device)))

    def sample_per_shard(self, k: int, seed: int = 0) -> "SparseDataset":
        """≤ k rows a shard at evenly spread global indices; on a mesh
        the same rows on every rank, one process's sample of ``k ·
        shards`` rows (each rank's picks gathered), not placed."""
        shards = axis_size(self.mesh, DATA_AXIS)
        m = min(self.total, k * shards)
        idx = np.linspace(0, self.total - 1, num=m, dtype=np.int64)
        if self.mesh is None:
            return SparseDataset(self.matrix[idx], device=self.device)
        from ..parallel.collectives import all_gather_objects

        lo = self.first_row
        mine = idx[(idx >= lo) & (idx < lo + self.count)] - lo
        return SparseDataset(sp.vstack(all_gather_objects(
            self.matrix[mine], self.mesh), format="csr"), device=self.device)

    def cache(self) -> "SparseDataset":
        return self

    def gather(self) -> sp.csr_matrix:
        """The whole CSR in global order, on every rank (on a mesh one
        gather of every rank's rows through the host)."""
        if self.mesh is None:
            return self.matrix
        from ..parallel.collectives import all_gather_objects

        return sp.vstack(all_gather_objects(self.matrix, self.mesh),
                         format="csr")

    def numpy(self) -> sp.csr_matrix:
        return self.gather()

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        shards = (f", total={self.total}, shards="
                  f"{axis_size(self.mesh, DATA_AXIS)}"
                  if self.mesh is not None else "")
        return (f"SparseDataset(count={self.count}, dim={self.dim}, "
                f"nnz={self.matrix.nnz}{shards})")


def padded_form_ok(n: int, w: int, nnz: int,
                   device: DeviceLike = "cuda") -> bool:
    """Whether the width-padded form of an (n rows, w slots, nnz) matrix
    is a sane size (`:86-98`): at most `PADDED_SHARE` of ``device``'s
    memory (ids and values, 8 bytes a slot), and, above 32 MB, at most
    16× the bytes of the nonzeros. One outlier-dense row (a ones column,
    one long document) makes w the dimension and the padding O(n·d)."""
    padded_bytes = 8.0 * n * w
    return padded_bytes <= PADDED_SHARE * memory_budget(device) and not (
        padded_bytes > 32e6 and padded_bytes > 16.0 * 8.0 * max(nnz, 1))


def pad_csr(matrix, width: Optional[int] = None
            ) -> "tuple[np.ndarray, np.ndarray]":
    """Host CSR → ELL rows: (n, w) int32 column ids and float32 values,
    row r's nonzeros in slots [0, len_r), the rest the sentinel column
    ``dim`` with value 0 (`:101-124`, there slot-major). ``w`` is the
    widest row's length, or ``width`` where given (not narrower)."""
    X = sp.csr_matrix(matrix)
    n, d = X.shape
    w = _row_width(X) if width is None else int(width)
    lens = np.diff(X.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    slots = np.arange(X.nnz, dtype=np.int64) - np.repeat(
        X.indptr[:-1].astype(np.int64), lens)
    idx = np.full((n, w), d, np.int32)
    val = np.zeros((n, w), np.float32)
    idx[rows, slots] = X.indices
    val[rows, slots] = X.data
    return idx, val


def _row_width(X: sp.csr_matrix) -> int:
    """Slots of the widest row (at least 1)."""
    return max(1, int(np.diff(X.indptr).max()) if X.shape[0] else 1)


def _ell_csr(idx: torch.Tensor, val: torch.Tensor, ncols: int):
    """ELL rows (n, w) as the CSR of an (n, ncols) matrix whose slots all
    count, the padding included (row pointers w apart)."""
    n, w = idx.shape
    itype = torch.int32 if n * w < 2**31 else torch.int64
    crow = torch.arange(0, n * w + 1, w, dtype=itype, device=idx.device)
    return torch.sparse_csr_tensor(crow, idx.reshape(-1).to(itype),
                                   val.reshape(-1), size=(n, ncols),
                                   check_invariants=False)


class PaddedSparseDataset(_Placed):
    """Width-padded sparse rows on a device (`:127-249`).

    ``idx`` (n, w) int32 column ids, the sentinel ``dim`` in unused
    slots; ``val`` (n, w) float32, 0 there. The optional column form
    ``cidx``/``cval`` (dim, wc) holds, for each feature column, the ids
    of the rows that contain it (sentinel ``count``) and their values,
    so a product with Xᵀ is a product with another padded matrix rather
    than a scatter-add. ``nnz`` is the true nonzero count (of the rows
    held here). On a mesh the rows are this rank's of ``total``, the
    column form theirs."""

    is_dataset = True

    def __init__(self, idx: torch.Tensor, val: torch.Tensor, dim: int,
                 nnz: Optional[int] = None, cidx: Optional[torch.Tensor] = None,
                 cval: Optional[torch.Tensor] = None, mesh=None,
                 total: Optional[int] = None):
        if idx.shape != val.shape or idx.ndim != 2:
            raise ValueError(f"idx {tuple(idx.shape)} and val "
                             f"{tuple(val.shape)} must be one (n, w) shape")
        self.idx, self.val, self.dim = idx, val, int(dim)
        self.nnz = int(nnz) if nnz is not None else idx.numel()
        self.cidx, self.cval = cidx, cval
        self._place(mesh, idx.shape[0] if total is None else int(total))

    @classmethod
    def from_csr(cls, matrix, device: DeviceLike = "cuda",
                 column_form: bool = True,
                 max_col_pad_ratio: float = 16.0,
                 mesh=None) -> "PaddedSparseDataset":
        """The padded form of a host CSR, copied to ``device`` once; the
        column form too unless its padding would exceed
        ``max_col_pad_ratio`` times the nonzeros (and 1e6 slots), as a
        column in every row makes it O(dim · n) (`:159-182`). Raises
        where the row padding fails `padded_form_ok`: `SparseDataset`
        holds such a matrix without padding. ``matrix`` may be a
        `SparseDataset`, whose placement it takes; ``mesh``: place the
        whole CSR's rows over it. On a mesh every rank's rows are padded
        to the widest row over all ranks (one gather of a width a rank
        where the rows came placed)."""
        dev = resolve_device(device)
        if isinstance(matrix, SparseDataset):
            X, mesh, total = matrix.matrix, matrix.mesh, matrix.total
            w = _row_width(X)
            if mesh is not None:
                from ..parallel.collectives import all_gather_objects

                w = max(all_gather_objects(w, mesh))
        else:
            whole = sp.csr_matrix(matrix)
            w = _row_width(whole)
            X, total = _whole_rows(whole, mesh, None)
        n, d = X.shape
        if not padded_form_ok(n, w, X.nnz, dev):
            raise ValueError(
                f"padding {n} rows to width {w} ({8.0 * n * w:.3g} bytes) "
                f"for {X.nnz} nonzeros is outside padded_form_ok")
        idx, val = pad_csr(X, w)
        cidx = cval = None
        if column_form and d > 0:
            wc = max(1, int(np.diff(X.tocsc().indptr).max()))
            if d * wc <= max(max_col_pad_ratio * max(X.nnz, 1), 1e6):
                ci, cv = pad_csr(X.T.tocsr())
                cidx = torch.from_numpy(ci).to(dev)
                cval = torch.from_numpy(cv).to(dev)
        return cls(torch.from_numpy(idx).to(dev),
                   torch.from_numpy(val).to(dev), d, nnz=X.nnz,
                   cidx=cidx, cval=cval, mesh=mesh, total=total)

    def with_column_form(self) -> "PaddedSparseDataset":
        """This dataset with its column form built on the device
        (`:184-227`): a stable sort of the slots by column, each column's
        slots at its rows' positions. The sentinel slots sort last and
        are written to a dropped row ``dim``; the width (the longest
        column) is read on the host, one synchronizing call."""
        if self.cidx is not None:
            return self
        n, w = self.idx.shape
        d, dev = self.dim, self.idx.device
        flat = self.idx.reshape(-1).long()
        order = torch.argsort(flat, stable=True)
        cols = flat[order]
        rows = torch.div(order, w, rounding_mode="floor")
        starts = torch.searchsorted(cols, torch.arange(d + 1, device=dev))
        counts = torch.diff(starts)
        wc = max(1, int(counts.max())) if d else 1
        pos = torch.arange(flat.numel(), device=dev) - starts[cols]
        # the sentinel column's slots land in dropped row d, slot 0
        pos = torch.where(cols < d, pos, 0)
        cidx = torch.full((d + 1, wc), n, dtype=torch.int32, device=dev)
        cval = torch.zeros((d + 1, wc), dtype=self.val.dtype, device=dev)
        cidx[cols, pos] = rows.to(torch.int32)
        cval[cols, pos] = self.val.reshape(-1)[order]
        return PaddedSparseDataset(self.idx, self.val, d, nnz=self.nnz,
                                   cidx=cidx[:d], cval=cval[:d],
                                   mesh=self.mesh, total=self.total)

    def csr(self) -> torch.Tensor:
        """The rows as an (n, dim + 1) CSR, padding included: column
        ``dim`` is the sentinel, its values 0."""
        return _ell_csr(self.idx, self.val, self.dim + 1)

    def csr_t(self) -> torch.Tensor:
        """Xᵀ as a (dim, n + 1) CSR from the column form (sentinel row
        ``n`` as the last column); `with_column_form` builds it first."""
        if self.cidx is None:
            raise ValueError("no column form; call with_column_form()")
        return _ell_csr(self.cidx, self.cval, self.count + 1)

    @property
    def count(self) -> int:
        """Rows held here (this rank's on a mesh)."""
        return self.idx.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    @property
    def sparsity(self) -> float:
        return self.nnz / max(self.count * self.dim, 1)

    @property
    def nbytes(self) -> int:
        """Device bytes of the row form and of the column form, if any."""
        return sum(t.numel() * t.element_size() for t in (
            self.idx, self.val, self.cidx, self.cval) if t is not None)

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"PaddedSparseDataset(count={self.count}, dim={self.dim}, "
                f"width={self.width})")
