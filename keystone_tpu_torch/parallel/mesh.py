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
  - axis ``"model"``: the feature axis (JAX `:8-14`, the reference's
    `VectorSplitter` feature blocking). On a ``(data, model)`` mesh a
    `Dataset`'s 2-D leaf whose width the model axis divides is held as
    this rank's ``(rows, columns)`` tile (`feature_sharding`); ranks are
    laid out row-major, so the ranks of one model group are consecutive
    and share their rows.

With no process group there is no mesh: `current_mesh()` is None and
every path runs as in one process (``n_data_shards() == 1``).

The static tier (`analysis/sharding.py`, `analysis/planner.py`) needs a
mesh's shape without its processes, so that a 2x4 layout can be planned
from one card or from the CPU: `MeshLayout` is that description, a
plain ``{"data": d, "model": m}`` with JAX's `Mesh` attributes the
analysis reads (``shape``, ``axis_names``, ``size``); `layout_of` makes
one from a live mesh, a dict, or None (one card).

A `PartitionSpec` is the port's own small tuple of axis names (entries
None, a name, or a tuple of names), as JAX's spec helpers read it.
`shard_leading_axis` has no counterpart: a rank's rows are placed by
`Dataset` (`Dataset.from_numpy(x, mesh=...)`); `data_spec`,
`data_sharding`, `replicated_sharding` and `spec_of_array` name
`NamedSharding`s, which torch has not: a `Dataset`'s placement is its
``spec``.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

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
    """A `DeviceMesh` over every rank of the process group (JAX
    `:37-49`). Default: the whole group on a 1-D ``data`` axis; a
    ``(data, model)`` shape lays the ranks out row-major."""
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
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


#: where the group's ranks hold their data when it is not NCCL's card:
#: "cuda" once `multihost.init_multihost` opened gloo over the card
_group_device = "cpu"


def mesh_device(mesh) -> str:
    """The device type a mesh's ranks hold their data on: the card under
    NCCL, or under gloo opened over the card (two ranks on one card);
    else the CPU. (`DeviceMesh.device_type` follows the backend.)"""
    if mesh is None:
        return "cuda"
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return _group_device


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
    axis); ``mesh`` a live mesh or a `MeshLayout`."""
    if mesh is None:
        return 1
    if isinstance(mesh, MeshLayout):
        return int(mesh.shape.get(axis, 1))
    if axis not in (mesh.mesh_dim_names or ()):
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
    """The process group of the data axis: the ranks that share this
    rank's model index."""
    return mesh.get_group(DATA_AXIS)


def model_rank(mesh) -> int:
    """This process's index along the model axis (0 without one)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return 0
    return int(mesh.get_local_rank(MODEL_AXIS))


def model_group(mesh):
    """The process group of the model axis: the ranks that hold this
    rank's rows."""
    return mesh.get_group(MODEL_AXIS)


def axis_group(mesh, axis: str):
    return data_group(mesh) if axis == DATA_AXIS else model_group(mesh)


def feature_sharding(mesh=None, d: Optional[int] = None):
    """``P("data", "model")`` for an (n, d) solver matrix (JAX
    `:98-114`): the feature-axis scale-out that replaces the reference's
    VectorSplitter blocking. None on a mesh without a model axis, and
    where ``d`` is given and the model axis does not divide it (such a
    matrix stays model-replicated)."""
    mesh = mesh if mesh is not None else current_mesh()
    shards = axis_size(mesh, MODEL_AXIS)
    if shards <= 1:
        return None
    if d is not None and d % shards != 0:
        return None
    return P(DATA_AXIS, MODEL_AXIS)


# ------------------------------------------------------------ mesh layout


class MeshLayout:
    """A mesh's shape without its processes: what the static tier
    reads of JAX's `Mesh` (``shape``, ``axis_names``, ``devices.size``)
    for a ``{"data": d, "model": m}`` layout."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"MeshLayout({self.shape})"


#: one card: the default layout, JAX's default mesh over one device
ONE_CARD = MeshLayout({DATA_AXIS: 1})


def layout_of(mesh=None) -> MeshLayout:
    """The `MeshLayout` of ``mesh``: a layout as it is, a dict
    (``{"data": 2, "model": 4}``) wrapped, a live `DeviceMesh` by its
    axes, and None the current mesh's (one card without a group)."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            return ONE_CARD
    if isinstance(mesh, MeshLayout):
        return mesh
    if isinstance(mesh, dict):
        return MeshLayout(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    return MeshLayout({n: axis_size(mesh, n) for n in names})


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
    """Number of distinct shards a PartitionSpec implies on ``mesh`` (a
    live mesh or a `MeshLayout`) — the product of the used axis sizes.
    P() → 1 (fully replicated)."""
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
# the sharding lints (`analysis/sharding.py` KP601/KP603), the sharding
# planner (`analysis/planner.py`) and the unified planner.


@dataclass(frozen=True)
class CollectiveCost:
    """One boundary collective: its kind, the bytes it moves between
    cards (what the KP6xx lints report and the planner minimizes) and
    their seconds at `cost_model.NETWORK_WEIGHT`, the card-to-card rate
    (NVLink 4's analytic 450 GB/s a direction, not measured)."""

    kind: str
    bytes_moved: int
    seconds: float


def _network_weight() -> float:
    # lazy: the cost model is a higher layer than the mesh
    from ..nodes.learning import cost_model

    return float(cost_model.NETWORK_WEIGHT)


def collective_cost(kind: str, nbytes: Optional[int], shards: int = 0,
                    mesh=None) -> CollectiveCost:
    """A boundary collective's price over ``shards`` (JAX `:213-242`;
    default: every card of ``mesh``, a live mesh, a `MeshLayout` or
    None for the current one). ``all_gather`` moves the whole value;
    ``all_to_all`` (a reshard between sharded layouts) and
    ``broadcast`` (a replicated value sent to the others) move
    ``nbytes·(shards−1)/shards``. A value whole on one card, or of
    unknown size, moves nothing."""
    if kind not in ("all_to_all", "all_gather", "broadcast"):
        raise ValueError(f"unknown collective kind {kind!r}")
    if not shards:
        shards = layout_of(mesh).size
    if not nbytes or shards <= 1:
        return CollectiveCost(kind, 0, 0.0)
    nbytes = int(nbytes)
    moved = nbytes if kind == "all_gather" \
        else (nbytes * (shards - 1)) // shards
    return CollectiveCost(kind, moved, moved * _network_weight())


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
    rank's rows only. Every estimator and evaluator of the package is
    marked; the guard holds for classes outside it. (A column tile never
    reaches such an ``obj``: `gather_model_inputs` gathers it first.)"""
    if getattr(type(obj), "mesh_aware", False):
        return
    for v in values:
        shards = axis_size(getattr(v, "mesh", None), DATA_AXIS)
        if shards > 1:
            raise NotImplementedError(
                f"{type(obj).__name__} is not mesh-aware: it would fit or "
                f"score only this rank's rows of a dataset sharded "
                f"{shards} ways over {DATA_AXIS!r}; mark it mesh_aware "
                "once its fit reduces over every rank")


def _gathered(v):
    if getattr(v, "tiled", False):
        return v.gather_model()
    if isinstance(v, list):
        return [_gathered(x) for x in v]
    return v


def gather_model_inputs(obj, args: tuple, kwargs: dict):
    """``args`` and ``kwargs`` as a stage ``obj`` that is not marked
    ``model_aware`` takes them: each `Dataset` held as a column tile
    gathered over the model axis (one counted ``all_gather``), as GSPMD
    inserts the gather where a stage reads a model-sharded value in
    JAX. A model-aware stage runs on the tile."""
    if getattr(obj, "model_aware", False):
        return args, kwargs
    return (tuple(_gathered(a) for a in args),
            {k: _gathered(v) for k, v in kwargs.items()})
