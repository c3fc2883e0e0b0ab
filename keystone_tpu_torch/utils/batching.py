"""Batched application over items of mixed shapes.

Counterpart of the contract of `keystone_tpu/utils/batching.py::
map_host_batched` (`:669-695`): items are bucketed by shape, each bucket
is stacked and run through ``batch_fn`` in chunks, and the results come
back in item order. Here the results stay on the device. The JAX
package's overlap engine, its power-of-two pad ladder and its spill
windows are not ported (ROADMAP queue 1, item 9): a chunk is a slice of
its bucket, and the chunks' results are joined on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

#: items a chunk holds by default: it bounds the intermediates of the
#: descriptor extractors (about 20 floats a pixel for SIFT)
DEFAULT_CHUNK = 1024


def _shape_key(x) -> tuple:
    return tuple(x.shape), str(x.dtype)


def bucket_by_shape(items: Sequence) -> List[List[int]]:
    """Indices of the items grouped by (shape, dtype), groups in order of
    first appearance, indices ascending within a group."""
    groups: Dict[tuple, List[int]] = {}
    for i, x in enumerate(items):
        groups.setdefault(_shape_key(x), []).append(i)
    return list(groups.values())


def run_chunked(fn: Callable[[torch.Tensor], torch.Tensor],
                stacked: torch.Tensor,
                chunk: Optional[int] = DEFAULT_CHUNK) -> torch.Tensor:
    """``fn`` over ``stacked`` in leading-axis slices of at most ``chunk``
    (None: all at once), the results concatenated. ``fn`` must act on
    each item of the leading axis alone."""
    n = stacked.shape[0]
    if chunk is None or n <= chunk:
        return fn(stacked)
    return torch.cat([fn(stacked[i:i + chunk]) for i in range(0, n, chunk)])


def map_host_batched(items: Sequence, batch_fn: Callable,
                     chunk: Optional[int] = DEFAULT_CHUNK,
                     device=None) -> List[torch.Tensor]:
    """``batch_fn`` on items of any shapes: one stacked call a bucket
    chunk; the per-item results (views of each bucket's output, on the
    device) in item order. ``device``: where host items are stacked
    (None: the card)."""
    from ..data.dataset import HostDataset

    return HostDataset(items, device=device).map_batches(
        batch_fn, chunk).items
