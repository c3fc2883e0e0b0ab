"""Sparse feature vocabularies and vectorization, on the host.

Counterpart of `keystone_tpu/nodes/util/sparse_features.py` (`:24-86`;
reference nodes/util/CommonSparseFeatures.scala:19-64,
AllSparseFeatures.scala:14-27, SparseFeatureVectorizer). The vocabulary
is chosen exactly as the JAX package chooses it: `heapq.nlargest` on the
key (count, feature), so ties at the cut keep the larger features, and
the kept features sorted to number the columns. The output is a host CSR
`SparseDataset` whose arrays go to the device once, at its first product
(`data/sparse.py`).

On a mesh's data axis (a `HostDataset` of this rank's items) the
vectorizer's CSR holds this rank's rows, placed as its input, and the
vocabulary fits merge each rank's counts or features across ranks
(`parallel.merge_counts`, `all_gather_objects`) before choosing, so every
rank holds one process's vocabulary, JAX's over the whole host list.
"""

from __future__ import annotations

import heapq
from collections import Counter

import numpy as np
import scipy.sparse as sp

from ...data.sparse import SparseDataset
from ...parallel.collectives import all_gather_objects, merge_counts
from ...workflow.pipeline import Estimator, ItemTransformer


class SparseFeatureVectorizer(ItemTransformer):
    """(feature, value) pairs → CSR rows over a fixed vocabulary;
    features outside it are dropped and duplicates sum."""

    def __init__(self, vocab: dict):
        self.vocab = vocab

    def apply(self, pairs) -> sp.csr_matrix:
        """One item → a 1 × V CSR row."""
        acc: dict = {}
        for f, val in pairs:
            j = self.vocab.get(f)
            if j is not None:
                acc[j] = acc.get(j, 0.0) + val
        v = sp.dok_matrix((1, len(self.vocab)), dtype=np.float32)
        for j, val in acc.items():
            v[0, j] = val
        return v.tocsr()

    def apply_batch(self, data) -> SparseDataset:
        """A `HostDataset` of pair lists → a `SparseDataset` whose device
        and placement are the input's."""
        rows, cols, vals = [], [], []
        for i, pairs in enumerate(data.items):
            for f, val in pairs:
                j = self.vocab.get(f)
                if j is not None:
                    rows.append(i)
                    cols.append(j)
                    vals.append(val)
        mat = sp.csr_matrix(
            (vals, (rows, cols)), shape=(len(data.items), len(self.vocab)),
            dtype=np.float32)
        mesh = getattr(data, "mesh", None)
        return SparseDataset(mat, device=data.device, mesh=mesh,
                             total=data.total if mesh is not None else None)


class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` features that the most items hold
    (CommonSparseFeatures.scala:19-64: per-partition heaps and a merge,
    here one host `Counter` a rank, merged over the data axis)."""

    mesh_aware = True  # the counts merged over the data axis

    def __init__(self, num_features: int):
        self.num_features = num_features

    def fit(self, data) -> SparseFeatureVectorizer:
        counts: Counter = Counter()
        for pairs in data.items:
            for f, _ in pairs:
                counts[f] += 1
        counts = merge_counts(counts, getattr(data, "mesh", None))
        top = heapq.nlargest(self.num_features, counts.items(),
                             key=lambda kv: (kv[1], kv[0]))
        vocab = {f: i for i, f in enumerate(sorted(f for f, _ in top))}
        return SparseFeatureVectorizer(vocab)


class AllSparseFeatures(Estimator):
    """Vocabulary of every observed feature, sorted
    (AllSparseFeatures.scala:14-27); on a mesh every rank's features."""

    mesh_aware = True  # the feature sets gathered over the data axis

    def fit(self, data) -> SparseFeatureVectorizer:
        seen = set()
        for pairs in data.items:
            for f, _ in pairs:
                seen.add(f)
        seen = set().union(*all_gather_objects(
            seen, getattr(data, "mesh", None)))
        return SparseFeatureVectorizer(
            {f: i for i, f in enumerate(sorted(seen))})
