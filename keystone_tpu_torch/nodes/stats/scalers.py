"""Feature standardization.

Counterpart of `keystone_tpu/nodes/stats/scalers.py` (`_moments`,
`_scale`, `:22-84`; reference nodes/stats/StandardScaler.scala:36-60).
The moments are one pass of sums over the rows, as in the JAX package.
On a mesh (`parallel/`) they are `tree_aggregate`'s sums of this rank's
valid rows (the mask zeroes the padded ones), one all-reduce of the sum
and the sum of squares over ``data``, divided by the global count, and
the scaled rows re-zero the padded ones (`_scale`'s mask, `:38-39, 84`;
`Transformer.apply_batch` applies it for ``fuse_masks_output``). In one
process there are no padded rows and no collective.

On a ``(data, model)`` mesh both run on a column tile (``model_aware``):
the fit's moments are those of this rank's columns, reduced over
``data`` only, then gathered over ``model`` (one all-gather of the two
vectors) so the fitted mean and std are whole, as JAX's are
replicated; the apply scales the tile by its columns' slice of them.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import all_gather_columns, tree_aggregate
from ...telemetry.instrument import record_dispatch
from ...workflow.pipeline import Estimator, Transformer, _rezero_padded


def moments(x: torch.Tensor, count: int, normalize_std: bool,
            mask=None, mesh=None):
    """Per-feature mean and unbiased std (std 1 where it is 0, and
    everywhere when ``normalize_std`` is False). With ``mesh``, ``x`` is
    this rank's rows, ``mask`` (or None: all valid) its valid ones and
    ``count`` the global count."""
    if mesh is None:
        s = x.sum(dim=0)
        s2 = (x * x).sum(dim=0)
    else:
        if mask is not None:
            x = x * mask.to(x.dtype)[:, None]
        s, s2 = tree_aggregate(
            x, lambda r: (r.sum(dim=0), (r * r).sum(dim=0)), mesh)
    mean = s / count
    if not normalize_std:
        return mean, torch.ones_like(mean)
    var = (s2 - count * mean * mean) / max(count - 1.0, 1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return mean, torch.where(std == 0.0, torch.ones_like(std), std)


class StandardScalerModel(Transformer):
    """(x − mean) / std, or x − mean when ``std`` is None."""

    precision_tolerance = "exact"

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    #: the JAX package's batch path re-zeros padded rows after this
    #: stage (`_scale`'s mask), so a chain kernel applies the row mask
    #: at its place in the chain (`scalers.py:42-75`)
    fuse_masks_output = True

    model_aware = True  # a tile scales by its columns' moments

    def __init__(self, mean: torch.Tensor, std=None):
        self.mean = mean
        self.std = std

    def batch_fn(self, cols: slice = slice(None)):
        """The scaling of rows, of the columns ``cols`` of the fitted
        width (all by default)."""
        mean = self.mean[cols]
        if self.std is None:
            return lambda x: x - mean
        std = self.std[cols]
        return lambda x: (x - mean) / std

    def apply_batch(self, data):
        if not getattr(data, "tiled", False):
            return super().apply_batch(data)
        lo = data.col_start
        out = data.map_batches(self.batch_fn(
            slice(lo, lo + data.array.shape[1])))
        return _rezero_padded(out, data)

    def fuse(self):
        """The JAX package's static key and parameters
        (`scalers.py:66-75`)."""
        if self.std is None:
            return ("StandardScaler", "center"), (self.mean,)
        return ("StandardScaler", "scale"), (self.mean, self.std)


class StandardScaler(Estimator):
    """Fit per-feature mean/std (StandardScaler.scala:36-60)."""

    precision_tolerance = "exact"  # `_moments` is an exact reduction

    fusable_fit = True

    mesh_aware = True  # moments all-reduced over the data axis

    model_aware = True  # a tile's moments, gathered over the model axis

    def __init__(self, normalize_std_dev: bool = True):
        self.normalize_std_dev = normalize_std_dev

    def abstract_fit(self, in_specs):
        """Static fit (`keystone_tpu/nodes/stats/scalers.py:99-119`):
        shape-preserving, but the fitted mean and std pin the feature
        dim."""
        from ...analysis.specs import (
            SpecMismatchError,
            TransformerSpec,
            leaf_vector_dim,
        )

        d = leaf_vector_dim(in_specs[0] if in_specs else None)

        def elem_fn(elem):
            if d is not None and getattr(elem, "ndim", None) == 1 \
                    and elem.shape[0] != d:
                raise SpecMismatchError(
                    f"StandardScaler was fit on {d}-dim features but is "
                    f"applied to a {elem.shape[0]}-dim element")
            return elem

        return TransformerSpec(elem_fn, label=self.label, chunkable=True)

    def fit(self, data) -> StandardScalerModel:
        record_dispatch()  # one batched call (JAX :122)
        mean, std = moments(data.array, data.count, self.normalize_std_dev,
                            data.mask if data.has_padding else None,
                            data.mesh)
        if data.tiled:
            mean, std = all_gather_columns(torch.stack([mean, std]),
                                           data.model_mesh).unbind(0)
        return StandardScalerModel(mean,
                                   std if self.normalize_std_dev else None)
