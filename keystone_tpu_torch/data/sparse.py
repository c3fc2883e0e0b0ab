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

`PaddedSparseDataset`, `pad_csr` and `padded_form_ok` (`:79-249`) wait
with `SparseLBFGSwithL2` (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import DeviceLike, resolve_device
from .dataset import Dataset


def _to_torch_csr(m: sp.csr_matrix, device: torch.device) -> torch.Tensor:
    """``m``'s index and value arrays copied to ``device`` once each."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr).to(device),
        torch.from_numpy(m.indices).to(device),
        torch.from_numpy(m.data.astype(np.float32, copy=False)).to(device),
        size=m.shape, check_invariants=False)


class SparseDataset:
    """A CSR matrix of examples (rows) on the host. ``device`` is where
    its device forms go (None: the card), resolved only when one is
    made."""

    is_dataset = True

    def __init__(self, matrix, device: DeviceLike = None):
        self.matrix = sp.csr_matrix(matrix)
        self.device = device
        self._csr: Optional[torch.Tensor] = None
        self._csr_t: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.matrix.shape[0]

    @property
    def dim(self) -> int:
        return self.matrix.shape[1]

    @property
    def nnz(self) -> int:
        return self.matrix.nnz

    @property
    def sparsity(self) -> float:
        """Fraction of nonzeros."""
        r, c = self.matrix.shape
        return self.matrix.nnz / max(r * c, 1)

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
        return SparseDataset(fn(self.matrix), device=self.device)

    def densify(self, dtype=np.float32) -> Dataset:
        """The rows as a dense device `Dataset`."""
        return Dataset(np.asarray(self.matrix.todense(), dtype=dtype),
                       device=resolve_device(self.device))

    @property
    def per_shard_count(self) -> int:
        """Rows a shard: one card is one shard."""
        return self.count

    def sample_per_shard(self, k: int, seed: int = 0) -> "SparseDataset":
        """``k`` rows evenly spaced (one device: one shard)."""
        m = min(self.count, k)
        idx = np.linspace(0, self.count - 1, num=m, dtype=np.int64)
        return SparseDataset(self.matrix[idx], device=self.device)

    def cache(self) -> "SparseDataset":
        return self

    def numpy(self) -> sp.csr_matrix:
        return self.matrix

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"SparseDataset(count={self.count}, dim={self.dim}, "
                f"nnz={self.matrix.nnz})")
