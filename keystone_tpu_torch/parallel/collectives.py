"""The distributed communication backend, stated explicitly.

Counterpart of `keystone_tpu/parallel/collectives.py` (`:1-214`). The
reference's comm backend is Spark's bulk-synchronous model (torrent
broadcast, `treeReduce`/`treeAggregate`, co-partitioned `zip`,
shuffles; SURVEY.md §2.7). JAX reaches XLA's collectives two ways, GSPMD
inserting them where sharded math needs them and `shard_map` naming
them. The port has one way: every reduction over rows is one of the
functions below, an explicit `torch.distributed` call on the mesh's
data-axis group (NCCL on the card, gloo on the CPU), outside any
kernel. Only the data axis's specs exist here, ``P()`` (replicated) and
``P("data")`` (a rank's rows): a `Dataset` placed on a mesh is
``P("data")``, a plain tensor ``P()``.

JAX's program cache (`_cached`, `_fn_key`) keeps a jitted program per
collective and callback; eager torch builds no program, so there is
nothing to cache and neither is ported.

Every call adds one to ``collectives.<kind>`` and its payload's bytes
to ``collectives.<kind>.bytes`` in the telemetry registry, and under a
tracer it is one span of category ``collective`` named by its kind,
with its ``bytes``. Under a synchronizing tracer (``trace_run(...,
synchronize=True)``) the span opens after the card has finished the
work queued before it and closes once the collective itself has, so its
seconds are the collective's; otherwise they are what the host waited
(all of it under gloo, which blocks).

The reducing collectives (`all_reduce`, `psum`) take the mesh as a
required argument, since a sum over ranks of a replicated value is
wrong: `tree_reduce_sum` and `tree_aggregate` reduce over the mesh a
`Dataset` is placed on, or the one given.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from ..telemetry.metrics import counter
from ..telemetry.spans import current_tracer, span
from . import mesh as meshlib


def _collective(kind: str, t: torch.Tensor, call) -> None:
    """Run ``call()``, one collective on ``t``: counted, and a span
    under a tracer."""
    nbytes = t.numel() * t.element_size()
    counter(f"collectives.{kind}").inc()
    counter(f"collectives.{kind}.bytes").inc(float(nbytes))
    tracer = current_tracer()
    if tracer is None:
        call()
        return
    sync = tracer.synchronize and t.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(t.device)
    with span(kind, cat="collective", bytes=nbytes):
        call()
        if sync:
            torch.cuda.synchronize(t.device)


def _mesh(mesh):
    return mesh if mesh is not None else meshlib.current_mesh()


def all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over ``mesh``'s data axis, in place (returned).
    ``mesh`` None (one process): ``t`` as it is."""
    if mesh is None:
        return t
    _collective("all_reduce", t, lambda: dist.all_reduce(
        t, group=meshlib.data_group(mesh)))
    return t


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, it) for x in tree)
    return next(it)


def _packed(tree, op):
    """``op`` on one flat buffer a dtype holding every tensor leaf of
    ``tree`` (one collective a dtype, not one a leaf); the tree of the
    results, leaves in their shapes."""
    leaves = _leaves(tree)
    device = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
                  None)
    leaves = [x if isinstance(x, torch.Tensor)
              else torch.as_tensor(x, device=device) for x in leaves]
    out = list(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        op(flat)
        offset = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[offset:offset + n].reshape(leaves[i].shape)
            offset += n
    return _unflatten(tree, iter(out))


def psum(tree, mesh):
    """A tuple, list or dict of tensors (or one) summed over ``mesh``'s
    data axis, one all-reduce a dtype: JAX's ``lax.psum`` over ``data``,
    the all-reduce GSPMD inserts at a reduction over sharded rows.
    ``mesh`` None: ``tree`` as it is."""
    if mesh is None:
        return tree
    return _packed(tree, lambda flat: all_reduce(flat, mesh))


def _rows(x):
    """A dataset's rows with its padded rows zeroed, or a tensor."""
    if hasattr(x, "mask") and hasattr(x, "array"):
        from ..data.dataset import mask_rows

        return mask_rows(x.array, x.mask) if x.has_padding else x.array
    return x


def _placed_on(x, mesh):
    """The mesh a reduction of ``x`` runs over: ``mesh``, else a
    `Dataset`'s own; a tensor without one is replicated."""
    return mesh if mesh is not None else getattr(x, "mesh", None)


def tree_reduce_sum(x, mesh=None, axis: str = meshlib.DATA_AXIS):
    """≈ `rdd.treeReduce(_ + _)` of per-shard partial sums (`:94-112`):
    this rank's rows (a tensor, or a `Dataset` whose padded rows count as
    zero) summed over the leading dim, then all-reduced over ``axis`` of
    ``mesh`` (default: the `Dataset`'s; a tensor given no mesh is
    replicated, so its sum is the total). The replicated total."""
    _check_axis(axis)
    return all_reduce(_rows(x).sum(dim=0), _placed_on(x, mesh))


def tree_aggregate(x, seq_op, mesh=None, axis: str = meshlib.DATA_AXIS):
    """≈ `treeAggregate(zero)(seqOp, combOp)` with combOp `+`
    (`:115-128`): ``seq_op`` maps this rank's rows (as `tree_reduce_sum`
    takes them) to a partial aggregate (a tensor, a number, or a tuple,
    list or dict of them), and one all-reduce a dtype sums the leaves
    over ``mesh`` (default as in `tree_reduce_sum`).
    (StandardScaler.scala:46's moment aggregation shape.)"""
    _check_axis(axis)
    return psum(seq_op(_rows(x)), _placed_on(x, mesh))


def broadcast(x, mesh=None, src: int = 0):
    """≈ `sc.broadcast(model)` (`:131-134`): the data axis's rank
    ``src``'s copy of ``x`` (a tensor, or a tuple, list or dict of
    them) on every rank, one broadcast a dtype. Without a mesh, ``x``."""
    mesh = _mesh(mesh)
    if mesh is None:
        return x
    group = meshlib.data_group(mesh)
    root = dist.get_global_rank(group, src)

    def op(flat):
        _collective("broadcast", flat, lambda: dist.broadcast(
            flat, src=root, group=group))

    out = _packed(x, op)
    return out


def co_sharded(a, b) -> bool:
    """≈ `rddA.zip(rddB)` precondition (`:137-147`): equal leading axes
    laid out alike, so an elementwise combination needs no collective.
    Two datasets: the same mesh and the same padded count; two tensors:
    the same leading length; a dataset and a tensor: never."""
    ma, mb = getattr(a, "mesh", None), getattr(b, "mesh", None)
    da, db = hasattr(a, "padded_count"), hasattr(b, "padded_count")
    if da != db:
        return False
    if da:
        return ma == mb and a.padded_count == b.padded_count
    return a.shape[0] == b.shape[0]


def all_gather_rows(x, mesh=None, axis: str = meshlib.DATA_AXIS):
    """≈ `rdd.collect()` onto every rank (`:150-161`): every rank's rows
    of ``x`` (a tensor of this rank's rows, or a `Dataset`'s) in rank
    order, on every rank: the full padded leading axis."""
    _check_axis(axis)
    mesh = _mesh(mesh)
    rows = x.array if hasattr(x, "padded_count") else x
    if mesh is None:
        return rows
    group = meshlib.data_group(mesh)
    rows = rows.contiguous()
    parts = [torch.empty_like(rows)
             for _ in range(dist.get_world_size(group))]
    _collective("all_gather", rows, lambda: dist.all_gather(
        parts, rows, group=group))
    return torch.cat(parts)


def reshard(x, spec, mesh=None):
    """≈ shuffle/repartition (`:164-187`): ``x`` moved to ``spec``. A
    `Dataset` is ``P("data")``: ``P()`` gathers its rows on every rank
    (its ``count`` rows, padding dropped). A tensor is ``P()``:
    ``P("data")`` keeps this rank's rows of it as a `Dataset` (every
    rank holds the whole tensor). Moving to the current layout returns
    ``x`` itself: no collective (the identity short-circuit)."""
    from ..data.dataset import Dataset

    mesh = _mesh(mesh)
    target = meshlib.spec_axes(spec)
    if target not in ((), (meshlib.DATA_AXIS,)):
        raise NotImplementedError(
            f"reshard to {spec!r}: the port places values over the data "
            "axis only (ROADMAP queue 1, item 4)")
    if isinstance(x, Dataset):
        if target and x.mesh == mesh:
            return x
        return all_gather_rows(x, x.mesh)[: x.count]
    if not target or mesh is None:
        return x
    return Dataset(x, mesh=mesh)


def reshard_tree(tree, spec, mesh=None):
    """`reshard` over a tuple, list or dict of values (`:190-214`),
    each leaf moved to ``spec``."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, spec, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(reshard_tree(v, spec, mesh) for v in tree)
    return reshard(tree, spec, mesh)


def _check_axis(axis: str) -> None:
    if axis != meshlib.DATA_AXIS:
        raise NotImplementedError(
            f"collectives over {axis!r}: the port reduces over the data "
            "axis only (ROADMAP queue 1, item 4)")
