"""The distributed communication backend, stated explicitly.

Counterpart of `keystone_tpu/parallel/collectives.py` (`:1-214`). The
reference's comm backend is Spark's bulk-synchronous model (torrent
broadcast, `treeReduce`/`treeAggregate`, co-partitioned `zip`,
shuffles; SURVEY.md §2.7). JAX reaches XLA's collectives two ways, GSPMD
inserting them where sharded math needs them and `shard_map` naming
them. The port has one way: every reduction over rows is one of the
functions below, an explicit `torch.distributed` call on one axis's
group of the mesh (NCCL on the card, gloo on the CPU, or gloo over the
card's tensors where two ranks share one card), outside any kernel. The
data axis's group holds the ranks that share this rank's model index;
the model axis's, the ranks that hold its rows. A plain tensor is
``P()``; a `Dataset` on a mesh is ``P("data")``, or ``P("data",
"model")`` where it holds a column tile (`Dataset.reshard` moves it).
`all_gather_columns` is the model axis's gather: the one that a stage
which does not run on a tile takes its input through. `gather_rows`
(rows by global index, a KRR block's) and `collect_rows` (JAX's
`_collect_rows`, one process's rows or sample on every rank) are the
data axis's gathers for the estimators that need some rows whole.
`all_gather_objects` and `merge_counts` move host values (a rank's
vocabulary counts, its n-gram tables, its CSR rows) where JAX's host
fits read the whole host list: one pickled payload a rank, gathered
through the host.

JAX's program cache (`_cached`, `_fn_key`) keeps a jitted program per
collective and callback; eager torch builds no program, so there is
nothing to cache and neither is ported.

Every call adds one to ``collectives.<kind>`` and its payload's bytes
to ``collectives.<kind>.bytes`` in the telemetry registry, and the same
to ``collectives.<axis>.<kind>`` and its ``.bytes`` for the mesh axis it
ran over; under a tracer it is one span of category ``collective``
named by its kind, with its ``bytes`` and ``axis``. Under a synchronizing tracer (``trace_run(...,
synchronize=True)``) the span opens after the card has finished the
work queued before it and closes once the collective itself has, so its
seconds are the collective's; otherwise they are what the host waited
(all of it under gloo, which blocks).

The reducing collectives (`all_reduce`, `psum`) and the row gathers
(`gather_rows`, `collect_rows`) take the mesh as a required argument
(None: one process), since a sum or gather over ranks of a replicated
value is wrong: `tree_reduce_sum` and `tree_aggregate` reduce over the mesh a
`Dataset` is placed on, or the one given.
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry.metrics import counter
from ..telemetry.spans import current_tracer, span
from . import mesh as meshlib


def _collective(kind: str, t: Optional[torch.Tensor], call,
                axis: str = meshlib.DATA_AXIS, nbytes: int = 0) -> None:
    """Run ``call()``, one collective on ``t`` over ``axis`` (``t``
    None: ``nbytes`` of host payload): counted, and a span under a
    tracer."""
    if t is not None:
        nbytes = t.numel() * t.element_size()
    for name in (f"collectives.{kind}", f"collectives.{axis}.{kind}"):
        counter(name).inc()
        counter(f"{name}.bytes").inc(float(nbytes))
    tracer = current_tracer()
    if tracer is None:
        call()
        return
    sync = (tracer.synchronize and t is not None
            and t.device.type == "cuda")
    if sync:
        torch.cuda.synchronize(t.device)
    with span(kind, cat="collective", bytes=nbytes, axis=axis):
        call()
        if sync:
            torch.cuda.synchronize(t.device)


def _mesh(mesh):
    return mesh if mesh is not None else meshlib.current_mesh()


def all_reduce(t: torch.Tensor, mesh,
               axis: str = meshlib.DATA_AXIS) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ``axis``, in place (returned).
    ``mesh`` None (one process), or an axis of one rank: ``t`` as it
    is."""
    _check_axis(axis)
    if mesh is None or (axis == meshlib.MODEL_AXIS
                        and meshlib.n_model_shards(mesh) == 1):
        return t
    _collective("all_reduce", t, lambda: dist.all_reduce(
        t, group=meshlib.axis_group(mesh, axis)), axis)
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


def psum(tree, mesh, axis: str = meshlib.DATA_AXIS):
    """A tuple, list or dict of tensors (or one) summed over ``mesh``'s
    ``axis``, one all-reduce a dtype: JAX's ``lax.psum``, the all-reduce
    GSPMD inserts at a reduction over sharded rows (``data``) or over a
    product's split inner dimension (``model``). ``mesh`` None: ``tree``
    as it is."""
    if mesh is None or (axis == meshlib.MODEL_AXIS
                        and meshlib.n_model_shards(mesh) == 1):
        return tree
    return _packed(tree, lambda flat: all_reduce(flat, mesh, axis))


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
    return all_reduce(_rows(x).sum(dim=0), _placed_on(x, mesh), axis)


def tree_aggregate(x, seq_op, mesh=None, axis: str = meshlib.DATA_AXIS):
    """≈ `treeAggregate(zero)(seqOp, combOp)` with combOp `+`
    (`:115-128`): ``seq_op`` maps this rank's rows (as `tree_reduce_sum`
    takes them) to a partial aggregate (a tensor, a number, or a tuple,
    list or dict of them), and one all-reduce a dtype sums the leaves
    over ``mesh`` (default as in `tree_reduce_sum`).
    (StandardScaler.scala:46's moment aggregation shape.)"""
    _check_axis(axis)
    return psum(seq_op(_rows(x)), _placed_on(x, mesh), axis)


def broadcast(x, mesh=None, src: int = 0, axis: str = meshlib.DATA_AXIS):
    """≈ `sc.broadcast(model)` (`:131-134`): ``axis``'s rank ``src``'s
    copy of ``x`` (a tensor, or a tuple, list or dict of them) on every
    rank of that axis, one broadcast a dtype. Without a mesh, ``x``."""
    _check_axis(axis)
    mesh = _mesh(mesh)
    if mesh is None or meshlib.axis_size(mesh, axis) == 1 and (
            axis == meshlib.MODEL_AXIS):
        return x
    group = meshlib.axis_group(mesh, axis)
    root = dist.get_global_rank(group, src)

    def op(flat):
        _collective("broadcast", flat, lambda: dist.broadcast(
            flat, src=root, group=group), axis)

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


def _gloo_on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is a card's tensor in a gloo group (two ranks on
    one card), whose gloo collectives are ``all_reduce`` and
    ``broadcast``."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def all_gather_columns(tile: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's column tiles of a (rows, w) matrix side by
    side, in model order: (rows, w·m) on every rank of the group, one
    collective over ``model`` (GSPMD's gather of a ``P("data",
    "model")`` value into ``P("data")``). Under gloo on the card it is
    an all-reduce of a zeroed (rows, w·m) buffer holding this rank's
    columns, which sums to the same bits (x + 0 = x); it is counted as
    the ``all_reduce`` it is."""
    m = meshlib.n_model_shards(mesh)
    if m == 1:
        return tile
    tile = tile.contiguous()
    group = meshlib.model_group(mesh)
    w = tile.shape[1]
    if _gloo_on_card(tile):
        out = tile.new_zeros((tile.shape[0], w * m))
        lo = meshlib.model_rank(mesh) * w
        out[:, lo:lo + w] = tile
        _collective("all_reduce", out, lambda: dist.all_reduce(
            out, group=group), meshlib.MODEL_AXIS)
        return out
    parts = [torch.empty_like(tile) for _ in range(m)]
    _collective("all_gather", tile, lambda: dist.all_gather(
        parts, tile, group=group), meshlib.MODEL_AXIS)
    return torch.cat(parts, dim=1)


def gather_block(tile: torch.Tensor, col_start: int, lo: int, hi: int,
                 mesh) -> torch.Tensor:
    """Columns ``lo:hi`` of the matrix whose columns ``col_start:
    col_start + w`` are ``tile``, on every rank of the model group: each
    rank writes its part of the block into a zeroed (rows, hi − lo)
    buffer and one all-reduce over ``model`` sums them (a block may
    span shards or lie inside one; columns no rank holds stay zero)."""
    out = tile.new_zeros((tile.shape[0], hi - lo))
    a = max(lo, col_start)
    b = min(hi, col_start + tile.shape[1])
    if a < b:
        out[:, a - lo:b - lo] = tile[:, a - col_start:b - col_start]
    return all_reduce(out, mesh, meshlib.MODEL_AXIS)


def all_gather_rows(x, mesh=None, axis: str = meshlib.DATA_AXIS):
    """≈ `rdd.collect()` onto every rank (`:150-161`): every rank's rows
    of ``x`` (a tensor of this rank's rows, or a `Dataset`'s) in rank
    order, on every rank of ``axis``: the full padded leading axis.
    Under gloo on the card, an all-reduce of a zeroed buffer (as
    `all_gather_columns`)."""
    _check_axis(axis)
    mesh = _mesh(mesh)
    rows = x.array if hasattr(x, "padded_count") else x
    if mesh is None:
        return rows
    group = meshlib.axis_group(mesh, axis)
    rows = rows.contiguous()
    size = dist.get_world_size(group)
    if _gloo_on_card(rows):  # as `all_gather_columns` does
        n = rows.shape[0]
        out = rows.new_zeros((n * size,) + tuple(rows.shape[1:]))
        lo = dist.get_group_rank(group, dist.get_rank()) * n
        out[lo:lo + n] = rows
        _collective("all_reduce", out, lambda: dist.all_reduce(
            out, group=group), axis)
        return out
    parts = [torch.empty_like(rows) for _ in range(size)]
    _collective("all_gather", rows, lambda: dist.all_gather(
        parts, rows, group=group), axis)
    return torch.cat(parts)


def _rank_starts(n_local: int, device, mesh, axis: str) -> np.ndarray:
    """Each rank's first global row and the total, (size + 1,), from
    every rank's ``n_local``: one all-reduce of a count a rank."""
    group = meshlib.axis_group(mesh, axis)
    counts = torch.zeros(dist.get_world_size(group), dtype=torch.int64,
                         device=device)
    counts[dist.get_group_rank(group, dist.get_rank())] = n_local
    all_reduce(counts, mesh, axis)
    return np.concatenate([[0], np.cumsum(counts.cpu().numpy())])


def gather_rows(rows: torch.Tensor, ids, mesh, starts=None,
                axis: str = meshlib.DATA_AXIS) -> torch.Tensor:
    """Rows ``ids`` (global indices, in their order, repeats allowed) of
    the matrix whose ranks along ``axis`` hold ``rows`` each, on every
    rank: a KRR block's anchors, a sample. Rank r holds global rows
    ``starts[r]:starts[r + 1]``; default ``rows.shape[0]`` a rank, a
    `Dataset`'s placement. Each rank contributes the rows it owns: one
    ``all_gather`` of a buffer as wide as the largest rank's share, or,
    under gloo on the card, one ``all_reduce`` of a zeroed (len(ids),
    …) buffer holding them (x + 0 = x, as `all_gather_columns`).
    ``mesh`` None (one process), or an axis of one rank:
    ``rows[ids]``."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    dev = rows.device
    if meshlib.axis_size(mesh, axis) == 1:
        return rows[torch.as_tensor(ids, device=dev)]
    group = meshlib.axis_group(mesh, axis)
    size = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    if starts is None:
        starts = np.arange(size + 1, dtype=np.int64) * rows.shape[0]
    owner = np.searchsorted(np.asarray(starts), ids, side="right") - 1
    mine = np.nonzero(owner == me)[0]
    local = torch.as_tensor(ids[mine] - starts[me], device=dev)
    tail = tuple(rows.shape[1:])
    if _gloo_on_card(rows):
        out = rows.new_zeros((len(ids),) + tail)
        out[torch.as_tensor(mine, device=dev)] = rows[local]
        _collective("all_reduce", out, lambda: dist.all_reduce(
            out, group=group), axis)
        return out
    counts = np.bincount(owner, minlength=size)
    buf = rows.new_zeros((int(counts.max()),) + tail)
    buf[:len(mine)] = rows[local]
    parts = [torch.empty_like(buf) for _ in range(size)]
    _collective("all_gather", buf, lambda: dist.all_gather(
        parts, buf, group=group), axis)
    out = rows.new_empty((len(ids),) + tail)
    for r in range(size):
        pos = np.nonzero(owner == r)[0]
        if len(pos):
            out[torch.as_tensor(pos, device=dev)] = parts[r][:len(pos)]
    return out


def collect_rows(rows: torch.Tensor, mesh,
                 max_rows: Optional[int] = None,
                 axis: str = meshlib.DATA_AXIS) -> torch.Tensor:
    """JAX's `_collect_rows` over a mesh
    (`keystone_tpu/nodes/learning/pca.py:82-99`): every rank's valid
    ``rows`` (any count a rank) in rank order, the rows one process
    holds, on every rank; above ``max_rows`` rows the same even
    `linspace` subsample of them. Only the rows kept move: one
    all-reduce of the counts, then `gather_rows`. ``mesh`` None: one
    process."""
    if meshlib.axis_size(mesh, axis) == 1:
        starts = np.array([0, rows.shape[0]])
    else:
        starts = _rank_starts(rows.shape[0], rows.device, mesh, axis)
    total = int(starts[-1])
    if max_rows is not None and total > max_rows:
        idx = np.linspace(0, total - 1, max_rows, dtype=np.int64)
    elif meshlib.axis_size(mesh, axis) == 1:
        return rows
    else:
        idx = np.arange(total, dtype=np.int64)
    return gather_rows(rows, idx, mesh, starts, axis)


def all_gather_objects(obj: Any, mesh,
                       axis: str = meshlib.DATA_AXIS) -> List[Any]:
    """Every rank's ``obj`` (any picklable host value) in rank order, on
    every rank of ``mesh``'s ``axis``: pickled once, the payloads moved
    by one ``all_gather_object`` through the host, counted as
    ``all_gather_object`` with the payload's bytes. ``mesh`` None, or an
    axis of one rank: ``[obj]``."""
    _check_axis(axis)
    if meshlib.axis_size(mesh, axis) == 1:
        return [obj]
    group = meshlib.axis_group(mesh, axis)
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    parts: List[Any] = [None] * dist.get_world_size(group)
    _collective("all_gather_object", None, lambda: dist.all_gather_object(
        parts, payload, group=group), axis, nbytes=len(payload))
    return [pickle.loads(p) for p in parts]


def merge_counts(counts, mesh, axis: str = meshlib.DATA_AXIS):
    """A mapping of counts (a `Counter`, a dict of numbers) summed over
    ``mesh``'s ``axis``: every rank's counts gathered (`all_gather_objects`)
    and added in rank order, the merge of the reference's per-partition
    counts (CommonSparseFeatures.scala:19-64). ``mesh`` None, or an axis
    of one rank: ``counts`` as it is."""
    parts = all_gather_objects(dict(counts), mesh, axis)
    if len(parts) == 1:
        return counts
    out: Counter = Counter()
    for part in parts:
        out.update(part)
    return out


def reshard(x, spec, mesh=None):
    """≈ shuffle/repartition (`:164-214`): ``x`` moved to ``spec``, one
    of ``P()``, ``P("data")``, ``P("data", "model")`` and ``P(None,
    "model")``. A `Dataset` moves by `Dataset.reshard`, except that
    ``P()`` gives the tensor of its ``count`` rows (every column) on
    every rank. A tensor is ``P()``: any other spec keeps this rank's
    part of it as a `Dataset` (every rank holds the whole tensor).
    Moving to the current layout returns ``x`` itself: no collective
    (the identity short-circuit)."""
    from ..data.dataset import Dataset

    mesh = _mesh(mesh)
    target = meshlib.spec_axes(spec)
    if any(a not in (meshlib.DATA_AXIS, meshlib.MODEL_AXIS) for a in target):
        raise ValueError(f"reshard to {spec!r}: no such mesh axis")
    if isinstance(x, Dataset):
        if not target:
            return x.gather()
        return x.reshard(spec, mesh)
    if not target or mesh is None:
        return x
    rows = meshlib.DATA_AXIS in meshlib.spec_axes((tuple(spec) + (None,))[0:1])
    cols = "auto" if meshlib.MODEL_AXIS in target else "full"
    if rows:
        return Dataset(x, mesh=mesh, cols=cols)
    return Dataset(x, cols=cols, model_mesh=mesh)


def reshard_tree(tree, spec, mesh=None):
    """`reshard` over a tuple, list or dict of values (`:190-214`),
    each leaf moved to ``spec``."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, spec, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(reshard_tree(v, spec, mesh) for v in tree)
    return reshard(tree, spec, mesh)


def _check_axis(axis: str) -> None:
    if axis not in (meshlib.DATA_AXIS, meshlib.MODEL_AXIS):
        raise ValueError(f"no mesh axis {axis!r}: the axes are "
                         f"{meshlib.DATA_AXIS!r} and {meshlib.MODEL_AXIS!r}")
