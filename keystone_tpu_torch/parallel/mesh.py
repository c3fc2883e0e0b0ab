"""The device mesh: one process per card in a `torch.distributed` group.

Counterpart of `keystone_tpu/parallel/mesh.py` (`:1-257`). JAX runs one
controller over a `jax.sharding.Mesh` and lets GSPMD insert the
collectives; the port follows PyTorch's own model: one process per card,
joined in a process group (NCCL on the card, gloo when the caller asked
for the CPU), and a `torch.distributed.device_mesh.DeviceMesh` over the
group's ranks with JAX's axis names. Conventions, as in JAX:

  - axis ``"data"``: the example axis. A `Dataset` placed on a mesh
    holds this rank's contiguous rows as a plain local tensor
    (`data/dataset.py`); every reduction over rows is an explicit,
    named collective of `collectives.py`.
  - axis ``"model"``: reserved. A mesh whose model axis is larger than
    1 raises until the model axis is ported (ROADMAP queue 1, item 4).

With no process group there is no mesh: `current_mesh()` is None and
every path runs as in one process (``n_data_shards() == 1``).

A `PartitionSpec` is the port's own small tuple of axis names (entries
None, a name, or a tuple of names), as JAX's spec helpers read it.
`shard_leading_axis` has no counterpart: a rank's rows are placed by
`Dataset` (`Dataset.from_numpy(x, mesh=...)`); `data_spec`,
`data_sharding`, `replicated_sharding`, `feature_sharding` and
`spec_of_array` name `NamedSharding`s, which torch has not.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_mesh_stack: list = []
_default_mesh = None


class PartitionSpec(tuple):
    """Placement of a value's axes over mesh axes: ``P()`` replicated,
    ``P("data")`` rows over the data axis (JAX's `PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call parallel.init_multihost(...) (or "
            "torch.distributed.init_process_group) before making a mesh")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = (DATA_AXIS,)):
    """A `DeviceMesh` over every rank of the process group. Default: the
    whole group on a 1-D ``data`` axis. A ``model`` axis larger than 1
    raises `NotImplementedError`."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) > 1:
            raise ValueError("shape is required for multi-axis meshes")
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh shape {shape} does not cover the group's "
                         f"{world} ranks")
    sizes = dict(zip(axis_names, shape))
    if sizes.get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            f"a {sizes[MODEL_AXIS]}-way {MODEL_AXIS!r} axis: the port "
            "shards the data axis only; the model axis is ROADMAP queue "
            "1, item 4")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def current_mesh():
    """The active mesh: the innermost `use_mesh`, else, once a process
    group exists, a process-wide default over all of its ranks on the
    ``data`` axis; None without a group (one process)."""
    if _mesh_stack:
        return _mesh_stack[-1]
    global _default_mesh
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


@contextmanager
def use_mesh(mesh):
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def reset_default_mesh() -> None:
    global _default_mesh
    _default_mesh = None
    _mesh_stack.clear()


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` of ``mesh`` (1 for no mesh or no such
    axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def n_data_shards(mesh=None) -> int:
    return axis_size(mesh if mesh is not None else current_mesh(),
                     DATA_AXIS)


def n_model_shards(mesh=None) -> int:
    return axis_size(mesh if mesh is not None else current_mesh(),
                     MODEL_AXIS)


def data_rank(mesh) -> int:
    """This process's index along the data axis (0 without a mesh)."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return 0
    return int(mesh.get_local_rank(DATA_AXIS))


def data_group(mesh):
    """The process group of the data axis."""
    return mesh.get_group(DATA_AXIS)


# ------------------------------------------------------- spec introspection
# (`:127-183`): one spelling of what a spec means on a mesh, shared by
# the collectives and the analysis tier.


def spec_axes(spec) -> Tuple[str, ...]:
    """Flat tuple of mesh axis names a PartitionSpec uses (entries may be
    None, a name, or a tuple of names)."""
    if spec is None:
        return ()
    out = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.extend(entry)
        else:
            out.append(entry)
    return tuple(out)


def spec_shards(spec, mesh=None) -> int:
    """Number of distinct shards a PartitionSpec implies on ``mesh`` —
    the product of the used axis sizes. P() → 1 (fully replicated)."""
    mesh = mesh if mesh is not None else current_mesh()
    n = 1
    for ax in spec_axes(spec):
        n *= axis_size(mesh, ax)
    return n


def specs_equal(a, b) -> bool:
    """Placement equality of two PartitionSpecs: equal after stripping
    trailing Nones (P('data') and P('data', None) place identically)."""

    def norm(s):
        entries = list(s) if s is not None else []
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(tuple(e) if isinstance(e, list) else e for e in entries)

    return norm(a) == norm(b)


# ---------------------------------------------------------- collective cost
#
# ONE pricing function for boundary collectives (`:185-242`), shared by
# the unified planner (`analysis/planner.py`) and, with the model axis,
# the sharding lints.


@dataclass(frozen=True)
class CollectiveCost:
    """One boundary collective: its kind, bytes moved and seconds."""

    kind: str
    bytes_moved: int
    seconds: float


def collective_cost(kind: str, nbytes: Optional[int],
                    shards: int = 1) -> CollectiveCost:
    """A boundary collective's price (JAX `:213-242`): a value that lives
    whole on one card moves nothing. A price over more than one shard
    needs the card-to-card rate, which comes with the sharding planner
    (ROADMAP queue 1, item 4)."""
    if kind not in ("all_to_all", "all_gather", "broadcast"):
        raise ValueError(f"unknown collective kind {kind!r}")
    if not nbytes or shards <= 1:
        return CollectiveCost(kind, 0, 0.0)
    raise NotImplementedError(
        "collectives across cards are priced with the sharding planner "
        "(ROADMAP queue 1, item 4)")


def replicate(x, mesh=None):
    """A value replicated across the mesh (≈ `sc.broadcast`; `:252-257`):
    rank 0's copy of ``x`` on every rank of the data axis. Without a
    mesh, ``x`` itself."""
    from .collectives import broadcast

    return broadcast(x, mesh)


def require_mesh_aware(obj, values: Iterable) -> None:
    """Raise where ``obj`` (an estimator or an evaluator) is not marked
    ``mesh_aware`` and one of ``values`` is a dataset placed on a mesh of
    more than one data shard: fitting or scoring it would read this
    rank's rows only."""
    if getattr(type(obj), "mesh_aware", False):
        return
    for v in values:
        shards = axis_size(getattr(v, "mesh", None), DATA_AXIS)
        if shards > 1:
            raise NotImplementedError(
                f"{type(obj).__name__} is not mesh-aware: it would fit or "
                f"score only this rank's rows of a dataset sharded "
                f"{shards} ways over {DATA_AXIS!r}; the data axis reaches "
                "it with ROADMAP queue 1, item 4")
