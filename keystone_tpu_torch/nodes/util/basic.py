"""Small utility nodes.

Counterpart of `ClassLabelIndicatorsFromInt`,
`ClassLabelIndicatorsFromIntArray` (`:89-122`), `MaxClassifier`,
`TopKClassifier` (`:157-163`), `VectorCombiner` (`:165-182`), `Densify`,
`Sparsify` (`:209-238`), `FloatToDouble` (`:241-244`), `MatrixVectorizer`
(`:246-259`), `Identity`, `Shuffler` (`:262-290`) and `Cacher` in
`keystone_tpu/nodes/util/basic.py` (reference
nodes/util/{ClassLabelIndicators,MaxClassifier,TopKClassifier,
VectorCombiner,Densify,Sparsify,FloatToDouble,MatrixVectorizer,
Identity,Shuffler,Cacher}.scala).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset, HostDataset
from ...data.sparse import SparseDataset
from ...workflow.pipeline import Transformer


class ClassLabelIndicatorsFromInt(Transformer):
    """int label → length-k float32 vector of −1/+1."""

    precision_tolerance = "exact"  # label stage: ±1 targets feed solvers

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, num_classes: int):
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes

    def batch_fn(self):
        return lambda y: (2.0 * F.one_hot(y.long(), self.num_classes)
                          - 1.0).to(torch.float32)

    def fuse(self):
        return ("ClassLabelIndicators", self.num_classes), ()


class ClassLabelIndicatorsFromIntArray(Transformer):
    """Multi-label int array → length-k float32 vector of −1/+1
    (ClassLabelIndicators.scala:38-55). Items are fixed-length label
    arrays padded with −1; the padding marks no class."""

    precision_tolerance = "exact"  # label stage: ±1 targets feed solvers

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def batch_fn(self):
        def fn(Y):
            classes = torch.arange(self.num_classes, device=Y.device)
            member = (Y.long()[..., None] == classes).any(dim=-2)
            return 2.0 * member.to(torch.float32) - 1.0

        return fn

    def fuse(self):
        return ("ClassLabelIndicatorsArray", self.num_classes), ()


class MaxClassifier(Transformer):
    """argmax over scores → int label (MaxClassifier.scala)."""

    precision_tolerance = "exact"

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        return lambda x: torch.argmax(x, dim=-1)

    def fuse(self):
        return ("MaxClassifier",), ()


class TopKClassifier(Transformer):
    """The indices of the k largest scores, largest first; ties in index
    order (a stable argsort of −x, as JAX's)."""

    def __init__(self, k: int):
        self.k = k

    def batch_fn(self):
        return lambda x: torch.argsort(-x, dim=-1, stable=True)[..., :self.k]


class VectorCombiner(Transformer):
    """Concatenate the list of branch outputs that gather produces along
    the last axis (VectorCombiner.scala)."""

    precision_passthrough = True

    def apply(self, xs):
        return torch.cat([torch.as_tensor(x) for x in xs], dim=-1)

    def apply_batch(self, data):
        # one output, allocated once, each branch copied into its columns;
        # one executed program, as JAX counts it (`basic.py:176-181`)
        from ...telemetry.instrument import record_dispatch

        record_dispatch()
        return data.with_data(torch.cat(data.data, dim=-1))


class Densify(Transformer):
    """`SparseDataset` → dense device `Dataset` on its device; one sparse
    row → a dense host vector (Densify.scala)."""

    def apply(self, x):
        return np.asarray(x.todense()).ravel() if sp.issparse(x) else x

    def apply_batch(self, data):
        return data.densify() if isinstance(data, SparseDataset) else data


class Sparsify(Transformer):
    """Device `Dataset` → host `SparseDataset` whose device is the
    rows' (Sparsify.scala)."""

    def apply(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return sp.csr_matrix(x)

    def apply_batch(self, data):
        if isinstance(data, SparseDataset):
            return data
        return SparseDataset(sp.csr_matrix(data.numpy()), device=data.device)


class FloatToDouble(Transformer):
    """To float64 where torch's default float type is float64, else to
    float32: JAX's rule (float64 only under ``jax_enable_x64``, which
    the JAX package's tests leave off) with torch's default dtype in
    the flag's place."""

    def batch_fn(self):
        dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
                 else torch.float32)
        return lambda x: x.to(dtype)


class MatrixVectorizer(Transformer):
    """Flatten each item's matrix to a vector, row-major
    (MatrixVectorizer.scala)."""

    precision_tolerance = "tolerant"  # reshape: values untouched

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        return lambda x: x.reshape(x.shape[0], -1)

    def fuse(self):
        return ("MatrixVectorizer",), ()


class Identity(Transformer):
    precision_passthrough = True  # see Cacher

    def apply(self, x):
        return x

    def apply_batch(self, data):
        return data


class Shuffler(Transformer):
    """A random permutation of the dataset (Shuffler.scala:16-19): the
    permutation `np.random.default_rng(seed)` draws, JAX's, so the order
    is JAX's; host items reordered, device rows gathered."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def apply(self, x):
        return x

    def apply_batch(self, data):
        idx = np.random.default_rng(self.seed).permutation(len(data))
        if isinstance(data, HostDataset):
            return HostDataset([data.items[i] for i in idx],
                               device=data.device)
        picked = data.array[torch.as_tensor(idx, device=data.device)]
        return Dataset(picked, count=data.count)


class Cacher(Transformer):
    """Materialize the dataset and mark its prefix saveable, so the
    prefix table keeps it across pipelines (Cacher.scala:15-25 with
    ExtractSaveablePrefixes): a later run of the same upstream chain on
    the same input starts here."""

    precision_passthrough = True

    saveable = True

    model_aware = True  # the identity: a tile stays a tile

    def __init__(self, name: str = ""):
        self.name = name

    @property
    def label(self) -> str:
        return f"Cacher[{self.name}]"

    def apply(self, x):
        return x

    def apply_batch(self, data):
        return data.cache() if hasattr(data, "cache") else data
