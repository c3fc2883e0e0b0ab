"""PCA family.

Counterpart of `keystone_tpu/nodes/learning/pca.py` (`:36-327`;
reference nodes/learning/PCA.scala:19-247, DistributedPCA.scala:20-74,
ApproximatePCA.scala:22-85):

- `PCAEstimator`, "local": the rows (at most ``sample_rows``, an even
  `linspace` subsample as in JAX) centred, their QR factor R, and the
  SVD of R. XᵀX = RᵀR, so V is the SVD's V of the centred rows, which
  JAX takes directly; the tall, skinny SVD becomes a QR (cuSOLVER's
  geqrf) and a d × d SVD;
- `DistributedPCAEstimator`: TSQR, a QR of each rank's centred rows
  and a QR of the gathered R factors, then the SVD of R; on one shard
  the QR of all the centred rows;
- `ApproximatePCAEstimator`: the randomized range finder with power
  iterations. Its Gaussian test matrix is a `torch.Generator` draw where
  JAX draws with `jax.random`, so it matches JAX's by subspace, not by
  value;
- `ColumnPCAEstimator` prices local against distributed PCA with
  `LocalPCACostModel` and `DistributedPCACostModel` (`:273-287`), JAX's
  formulas under `cost_model`'s weights.

Each component's sign is fixed as the reference's matlab convention
fixes it (`_sign_convention`), so components compare by value. Items may
be vectors or per-item descriptor matrices: `PCATransformer` maps the
last axis. The rows are gathered on the device (`collect_rows`), on a
mesh's data axis from every rank in one process's order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...data.dataset import Dataset, HostDataset
from ...device import resolve_device
from ...parallel.collectives import all_gather_rows, psum
from ...parallel.collectives import collect_rows as pcollect_rows
from ...parallel.mesh import DATA_AXIS, axis_size, n_data_shards
from ...workflow.pipeline import Estimator, OptimizableEstimator, Transformer
from .cost_model import CostModel, CostProfile


def _sign_convention(V: torch.Tensor) -> torch.Tensor:
    """Flip each column so its largest-|.| entry is positive
    (PCA.scala:196-206)."""
    idx = torch.argmax(V.abs(), dim=0)
    signs = torch.sign(V[idx, torch.arange(V.shape[1], device=V.device)])
    return V * signs


class PCATransformer(Transformer):
    """x @ components, x a vector or a (rows × d) descriptor matrix;
    components (d, k)."""

    def __init__(self, components: torch.Tensor):
        self.components = components

    def batch_fn(self):
        return lambda x: x.to(self.components.dtype) @ self.components


#: the reference's per-matrix variant
BatchPCATransformer = PCATransformer


def _local_rows(data) -> torch.Tensor:
    """The rows held here of a dataset of vectors or descriptor
    matrices, items in order, as one (n, d) tensor; a mesh dataset's
    padded items dropped."""
    if isinstance(data, HostDataset):
        buckets = data.buckets()
        idx, stacked = buckets[0]
        if len(buckets) == 1 and idx == list(range(len(data))):
            return stacked.reshape(-1, stacked.shape[-1])
        dev = resolve_device(data.device)
        return torch.cat([torch.atleast_2d(torch.as_tensor(x, device=dev))
                          for x in data.items])
    if isinstance(data, Dataset):
        X = data.array
        if data.has_padding:
            X = X[:int(data.mask.sum())]
        return X.reshape(-1, X.shape[-1]) if X.ndim == 3 else X
    return torch.atleast_2d(torch.as_tensor(data))


def collect_rows(data, max_rows: Optional[int] = None) -> torch.Tensor:
    """The rows of a dataset of vectors or descriptor matrices as one
    float32 (n, d) tensor on the device, items in order (the reference
    collects them to one machine, PCA.scala:177-185); above ``max_rows``
    rows an even `linspace` subsample of them. A dataset placed over a
    mesh's data axis (a `Dataset`, or a `HostDataset` of this rank's
    items) gives every rank the rows one process collects, in its order
    (`parallel.collect_rows`, JAX `_collect_rows` `:82-99`); only the
    rows kept move."""
    X = _local_rows(data)
    mesh = getattr(data, "mesh", None)
    if axis_size(mesh, DATA_AXIS) > 1:
        return pcollect_rows(X.to(torch.float32), mesh, max_rows)
    if max_rows is not None and X.shape[0] > max_rows:
        idx = np.linspace(0, X.shape[0] - 1, max_rows, dtype=np.int64)
        X = X[torch.as_tensor(idx, device=X.device)]
    return X.to(torch.float32)


def _components_of_centred(Xc: torch.Tensor) -> torch.Tensor:
    """V of the SVD of ``Xc`` from the SVD of its QR factor R."""
    R = torch.linalg.qr(Xc, mode="r")[1]
    _, _, Vt = torch.linalg.svd(R, full_matrices=False)
    return _sign_convention(Vt.T)


def _pca_fit_spec(dims: int, label: str, train_spec=None):
    """TransformerSpec of a to-be-fitted PCA
    (`keystone_tpu/nodes/learning/pca.py:108-137`): last axis d → dims,
    d pinned from the training spec where it is known."""
    from ...analysis.specs import (
        SpecMismatchError,
        TransformerSpec,
        is_known,
        shape_struct,
        tree_leaves,
    )

    d = None
    if train_spec is not None and is_known(
            getattr(train_spec, "element", None)):
        leaves = tree_leaves(train_spec.element)
        if len(leaves) == 1 and getattr(leaves[0], "ndim", 0) >= 1:
            d = int(leaves[0].shape[-1])

    def elem_fn(elem):
        if getattr(elem, "ndim", 0) < 1:
            raise SpecMismatchError(f"{label} input element must be ≥ 1-D")
        if d is not None and elem.shape[-1] != d:
            raise SpecMismatchError(
                f"{label} was fit on {d}-dim rows but the input element's "
                f"last axis is {elem.shape[-1]}")
        return shape_struct(tuple(elem.shape[:-1]) + (dims,), torch.float32)

    return TransformerSpec(elem_fn, label=label)


class PCAEstimator(Estimator):
    """Local PCA (PCA.scala:162-247): on a mesh every rank factors the
    sample one process collects (`collect_rows`)."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs
    mesh_aware = True  # the sample collected over the data axis

    def __init__(self, dims: int, sample_rows: Optional[int] = 100_000):
        self.dims = dims
        self.sample_rows = sample_rows

    def abstract_fit(self, in_specs):
        return _pca_fit_spec(self.dims, self.label,
                             in_specs[0] if in_specs else None)

    def fit(self, data) -> PCATransformer:
        X = collect_rows(data, self.sample_rows)
        V = _components_of_centred(X - X.mean(dim=0))
        return PCATransformer(V[:, :self.dims])


class DistributedPCAEstimator(Estimator):
    """PCA by TSQR and the SVD of R (DistributedPCA.scala:20-74; JAX
    `pca.py:156-224`). On a mesh's data axis: the mean all-reduced, a QR
    of each rank's valid centred rows, the d × d R factors gathered over
    ``data`` in rank order, a QR of their stack, then the SVD of R. One
    rank (no mesh) is the QR of all the centred rows."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs
    mesh_aware = True  # TSQR over the data axis

    def __init__(self, dims: int):
        self.dims = dims

    def abstract_fit(self, in_specs):
        return _pca_fit_spec(self.dims, self.label,
                             in_specs[0] if in_specs else None)

    def abstract_sharding(self, in_shardings, in_specs):
        """TSQR's first stage is a QR of each shard's rows (JAX
        `pca.py:198-205`): the rows must arrive data-sharded, or the
        fit reshards the whole matrix first (KP601). Static: the
        planner reads it."""
        from ...analysis.sharding import fit_sharding_demands

        return fit_sharding_demands(1)

    def fit(self, data) -> PCATransformer:
        mesh = getattr(data, "mesh", None)
        if axis_size(mesh, DATA_AXIS) == 1:
            X = collect_rows(data)
            mu = X.sum(dim=0) / X.shape[0]
            V = _components_of_centred(X - mu)
            return PCATransformer(V[:, :self.dims])
        X = _local_rows(data).to(torch.float32)
        d = X.shape[1]
        total, n = psum((X.sum(dim=0), X.new_tensor(float(X.shape[0]))),
                        mesh)
        R = torch.linalg.qr(X - total / n, mode="r")[1]
        if R.shape[0] < d:  # fewer rows here than columns
            R = torch.cat([R, R.new_zeros((d - R.shape[0], d))])
        R = torch.linalg.qr(all_gather_rows(R, mesh), mode="r")[1]
        _, _, Vt = torch.linalg.svd(R, full_matrices=False)
        return PCATransformer(_sign_convention(Vt.T)[:, :self.dims])


def randomized_components(X: torch.Tensor, k: int, q: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Halko–Martinsson–Tropp range finder with ``q`` power iterations
    (ApproximatePCA.scala:22-85): (d, k) components."""
    Xc = X - X.mean(dim=0)
    omega = torch.randn((X.shape[1], k), generator=generator,
                        dtype=X.dtype, device=X.device)
    Q = torch.linalg.qr(Xc @ omega)[0]
    for _ in range(q):
        Q = torch.linalg.qr(Xc.T @ Q)[0]
        Q = torch.linalg.qr(Xc @ Q)[0]
    _, _, Vt = torch.linalg.svd(Q.T @ Xc, full_matrices=False)
    return _sign_convention(Vt.T)


class ApproximatePCAEstimator(Estimator):
    """Randomized sketch PCA (ApproximatePCA.scala:22-85), on the rows
    `collect_rows` gives: on a mesh every rank's, as JAX's
    `_collect_rows` (`:259-268`)."""

    precision_tolerance = "exact"  # moments/decomposition: f32 inputs

    mesh_aware = True  # the rows collected over the data axis

    def __init__(self, dims: int, oversample: int = 10, q: int = 2,
                 seed: int = 0):
        self.dims = dims
        self.oversample = oversample
        self.q = q
        self.seed = seed

    def abstract_fit(self, in_specs):
        return _pca_fit_spec(self.dims, self.label,
                             in_specs[0] if in_specs else None)

    def abstract_sharding(self, in_shardings, in_specs):
        """TSQR's first stage is a QR of each shard's rows (JAX
        `pca.py:198-205`): the rows must arrive data-sharded, or the
        fit reshards the whole matrix first (KP601). Static: the
        planner reads it; the fit across ranks is TSQR's slice."""
        from ...analysis.sharding import fit_sharding_demands

        return fit_sharding_demands(1)

    def fit(self, data) -> PCATransformer:
        X = collect_rows(data)
        gen = torch.Generator(device=X.device).manual_seed(self.seed)
        V = randomized_components(X, self.dims + self.oversample, self.q,
                                  gen)
        return PCATransformer(V[:, :self.dims])


class LocalPCACostModel(CostModel):
    """Every row gathered to one device and one SVD there. JAX charges
    the gather, 4·n·d bytes at the network weight, on one device too."""

    def cost(self, p, cpu_weight=None, mem_weight=None, network_weight=None):
        cw, _, nw = self._weights(cpu_weight, mem_weight, network_weight)
        return nw * 4.0 * p.n * p.d + cw * (2.0 * p.n * p.d * p.d)


class DistributedPCACostModel(CostModel):
    """A QR a device, the d × d factors gathered, one small SVD."""

    def cost(self, p, cpu_weight=None, mem_weight=None, network_weight=None):
        cw, _, nw = self._weights(cpu_weight, mem_weight, network_weight)
        return cw * (2.0 * p.n * p.d * p.d / p.num_chips + 2.0 * p.d**3) + nw * (
            4.0 * p.d * p.d * p.num_chips)


class ColumnPCAEstimator(OptimizableEstimator):
    """The reference's cost-model choice between local and distributed
    PCA (PCA.scala:117-155). `optimize` prices both on
    (n, d, rows an item) measured from the sample, as JAX's does
    (`pca.py:289-327`), and records ``chosen``, the profile it priced
    (``cost_profile``) and both ``costs``; the fit without a sample is
    its default, local PCA. ``num_chips=None`` is the current mesh's data
    shards (one card without a group), as JAX reads them (`:309-327`)."""

    mesh_aware = True  # both routes are

    def __init__(self, dims: int, num_chips: Optional[int] = None):
        self.dims = dims
        self.num_chips = num_chips
        self.chosen = None
        self.cost_profile: Optional[CostProfile] = None
        self.costs: dict = {}

    def abstract_fit(self, in_specs):
        return _pca_fit_spec(self.dims, self.label,
                             in_specs[0] if in_specs else None)

    @property
    def default(self) -> Estimator:
        return PCAEstimator(self.dims)

    def profile(self, sample, num_per_shard: int) -> CostProfile:
        """(n, d) of the rows the fit would see, from a sample of items:
        vectors or descriptor matrices."""
        chips = self.num_chips or n_data_shards()
        if isinstance(sample, HostDataset) and len(sample):
            first = sample.items[0]
            d = first.shape[-1]
            rows_per_item = first.shape[0] if len(first.shape) == 2 else 1
        else:
            leaf = sample.array
            d = leaf.shape[-1]
            rows_per_item = leaf.shape[1] if leaf.ndim == 3 else 1
        return CostProfile(n=num_per_shard * chips * rows_per_item, d=d,
                           k=self.dims, sparsity=1.0, num_chips=chips)

    def optimize(self, sample, num_per_shard) -> Estimator:
        p = self.cost_profile = self.profile(sample, num_per_shard)
        self.costs = {"local": LocalPCACostModel().cost(p),
                      "distributed": DistributedPCACostModel().cost(p)}
        if self.costs["local"] <= self.costs["distributed"]:
            self.chosen = "local"
            return PCAEstimator(self.dims)
        self.chosen = "distributed"
        return DistributedPCAEstimator(self.dims)
