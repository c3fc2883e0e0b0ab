"""Static sharding analyzer: partition-spec propagation, per-device
memory, collective-cost lints (KP600–KP605).

Counterpart of `keystone_tpu/analysis/sharding.py:1-783`. Every stage
boundary of a lowered `Graph` is given a `PartitionSpec` (the port's
own, `parallel/mesh.py::P`) per element leaf, leading example axis
included, flowed the way `Dataset` places data on the ranks:

  - **seeded** from `Dataset`'s placement (`data/dataset.py`): the
    leading axis over ``"data"``; a 1-D element's feature axis also
    over ``"model"`` where the mesh has one and the width divides, the
    column tile a rank holds;
  - **propagated** through an operator's ``abstract_sharding`` hook
    where it declares one (the solver fits state their row-sharded
    input demands), else by the default rule: data sharding survives a
    device stage fed data-sharded rows, replicated inputs stay
    replicated, host stages carry none;
  - **overridden** by `PartitionRule`s (a regex on the stage label, the
    first match wins).

On top of the specs: the per-device memory model (`per_device_pass`,
each node's residency scaled by its shard's share, KP600 in KP202's
place at the full tier), and the boundary lints, each collective priced
by `parallel/mesh.py::collective_cost`: KP601 an implicit reshard,
KP602 a large operand held replicated, KP603 a host stage gathering
sharded data, KP604 a data-shard count that does not divide the example
count, KP605 a rule or hook placement the mesh cannot realize.

The mesh is any `parallel/mesh.py::layout_of` argument: a live mesh, a
``{"data": d, "model": m}`` layout, or None for the current one (one
card without a process group). Pure spec arithmetic on `DataSpec`s of
meta tensors: no data moves, no card allocates. Surfaced through
``validate(level="full")`` and ``python -m keystone_tpu_torch.analysis
--explain-sharding [--mesh-shape DATAxMODEL]``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..parallel import mesh as meshlib
from ..parallel.mesh import P, PartitionSpec
from ..workflow.graph import Graph, GraphId, NodeId, SinkId, SourceId
from .diagnostics import Diagnostic, Severity
from .memory import MemoryEstimate, _fmt_bytes, live_set_walk
from .propagate import _label, toposort
from .specs import UNKNOWN, DataSpec, is_known, tree_leaves, tree_map

#: replicated operands below this never trip KP602 (`:62-64`)
DEFAULT_REPLICATED_THRESHOLD = 64 << 20

#: `abstract_sharding` demand values (`:66-69`)
DEMAND_DATA_SHARDED = "data-sharded"
DEMAND_REPLICATED = "replicated"


def _spec_leaves(tree) -> List[PartitionSpec]:
    """The `PartitionSpec` leaves of a pytree of them (a spec is a tuple
    of entries, so it is a leaf here, not a subtree)."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _spec_leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [tree]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


# ------------------------------------------------------------------ values


@dataclass(frozen=True)
class ShardedValue:
    """Propagated sharding of one vertex (`:75-99`): a pytree of
    `PartitionSpec`s aligned with the vertex's `DataSpec` element
    leaves. Dataset specs are batch-level (a leading example axis); a
    datum's match its element's rank."""

    specs: Any
    kind: str = "dataset"  # "dataset" | "datum"

    def leaf_specs(self) -> List[PartitionSpec]:
        return _spec_leaves(self.specs)

    def max_shards(self, mesh=None) -> int:
        """Largest shard count any leaf is split into (1 = replicated)."""
        layout = meshlib.layout_of(mesh)
        return max((meshlib.spec_shards(s, layout)
                    for s in self.leaf_specs()), default=1)

    def __repr__(self) -> str:
        return f"ShardedValue[{spec_str(self)}]"


def spec_str(sv: Optional[ShardedValue]) -> str:
    """Human-readable spec, as JAX's (`:102-114`)."""
    if sv is None:
        return "—"

    def one(s) -> str:
        entries = ", ".join(repr(e) if e is not None else "None" for e in s)
        return f"P({entries})" if entries else "P()"

    leaves = sv.leaf_specs()
    if len(leaves) == 1:
        return one(leaves[0])
    return "(" + ", ".join(one(s) for s in leaves) + ")"


@dataclass(frozen=True)
class ShardingResult:
    """What an ``abstract_sharding(in_shardings, in_specs)`` hook
    returns (`:117-129`): ``out`` the output placement (None: the
    default rule decides), ``demands`` one input-layout demand a
    dependency (`DEMAND_DATA_SHARDED`, `DEMAND_REPLICATED` or None)."""

    out: Optional[ShardedValue] = None
    demands: Tuple[Optional[str], ...] = ()


def fit_sharding_demands(n_deps: int) -> ShardingResult:
    """The distributed solver's hook (`:132-137`): every training input
    must arrive row-sharded over ``data``; the fitted model is
    replicated state, so no output placement is declared."""
    return ShardingResult(demands=(DEMAND_DATA_SHARDED,) * n_deps)


@dataclass(frozen=True)
class PartitionRule:
    """A placement pin (`:140-152`): ``pattern`` is searched in the
    stage label and its ``label@vertex`` anchor; ``spec`` is pinned on
    every output leaf of the matching stage."""

    pattern: str
    spec: PartitionSpec

    def matches(self, label: str, anchor: str) -> bool:
        return re.search(self.pattern, label) is not None or \
            re.search(self.pattern, anchor) is not None


def _as_rules(rules) -> List[PartitionRule]:
    out = []
    for r in rules or ():
        if isinstance(r, PartitionRule):
            out.append(r)
        else:
            pattern, spec = r
            out.append(PartitionRule(pattern, spec))
    return out


# ----------------------------------------------------------------- seeding


def element_leaf_spec(mesh, elem_leaf) -> PartitionSpec:
    """The batch-level spec `Dataset` gives a leaf of this per-item
    shape (`:169-181`): rows over ``data``; a 1-D element's columns over
    ``model`` where the mesh has that axis and it divides the width."""
    shape = _shape(elem_leaf)
    if len(shape) == 1:
        model = int(mesh.shape.get(meshlib.MODEL_AXIS, 1))
        if model > 1 and shape[0] % model == 0:
            return P(meshlib.DATA_AXIS, meshlib.MODEL_AXIS)
    return P(meshlib.DATA_AXIS, *([None] * len(shape)))


def seed_sharding(spec: Any, mesh) -> Optional[ShardedValue]:
    """Placement of a freshly made value (`:184-198`); None for host
    values and unknown elements."""
    if not isinstance(spec, DataSpec) or not is_known(spec.element) \
            or not spec.on_device:
        return None
    mesh = meshlib.layout_of(mesh)
    if spec.kind == "datum":
        return ShardedValue(tree_map(
            lambda l: P(*([None] * len(_shape(l)))), spec.element),
            kind="datum")
    return ShardedValue(tree_map(lambda l: element_leaf_spec(mesh, l),
                                 spec.element), kind="dataset")


def _replicated_like(spec: DataSpec) -> Optional[ShardedValue]:
    if not is_known(spec.element):
        return None
    extra = 1 if spec.kind == "dataset" else 0
    return ShardedValue(tree_map(
        lambda l: P(*([None] * (len(_shape(l)) + extra))), spec.element),
        kind=spec.kind)


def _leading_axis(sv: Optional[ShardedValue]):
    """The mesh axis (or None) of the leading example dim, read off the
    first leaf (`:211-222`)."""
    if sv is None or sv.kind != "dataset":
        return None
    leaves = sv.leaf_specs()
    if not leaves or not len(leaves[0]):
        return None
    first = leaves[0][0]
    if isinstance(first, (tuple, list)):
        return first[0] if first else None
    return first


# ------------------------------------------------------------- propagation


def _is_host_stage(graph: Graph, vid: NodeId, specs: Dict) -> bool:
    """A provably host-code stage (`:228-253`): a plain transformer whose
    meta run died on host code (known inputs, UNKNOWN output) or whose
    output spec says host. Delegates and estimators are not."""
    from ..workflow.operators import (
        DelegatingOperator,
        EstimatorOperator,
        TransformerOperator,
    )

    op = graph.get_operator(vid)
    if isinstance(op, (DelegatingOperator, EstimatorOperator)):
        return False
    if not isinstance(op, TransformerOperator):
        return False
    out = specs.get(vid)
    if isinstance(out, DataSpec) and not out.on_device:
        return True
    in_specs = [specs.get(d) for d in graph.get_dependencies(vid)]
    data_in = [s for s in in_specs if isinstance(s, DataSpec)]
    if not data_in or not all(is_known(s.element) for s in data_in):
        return False
    return isinstance(out, DataSpec) and not is_known(out.element)


def sharding_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    mesh=None,
    rules: Sequence = (),
    plan: Optional[Dict[GraphId, ShardedValue]] = None,
    replicated_threshold_bytes: int = DEFAULT_REPLICATED_THRESHOLD,
) -> Tuple[Dict[GraphId, Optional[ShardedValue]], List[Diagnostic],
           Dict[NodeId, int]]:
    """Propagate partition specs over the graph and lint the boundaries
    (`:256-525`). Returns ``(shardings, diagnostics, boundary_costs)``,
    ``boundary_costs[vid]`` the bytes of collective traffic the
    placement implies at that stage's boundary. ``plan`` (the sharding
    planner's choices, `planner.plan_sharding`) replaces propagation and
    the rules on the vertices it covers; the lints still check it."""
    mesh = meshlib.layout_of(mesh)
    rules = _as_rules(rules)
    plan = plan or {}
    order, _ = toposort(graph)
    shardings: Dict[GraphId, Optional[ShardedValue]] = {}
    diags: List[Diagnostic] = []
    boundary: Dict[NodeId, int] = {}
    data_shards = int(mesh.shape.get(meshlib.DATA_AXIS, 1))
    flagged_counts: set = set()

    def add_cost(vid: NodeId, nbytes: Optional[int]) -> None:
        if nbytes:
            boundary[vid] = boundary.get(vid, 0) + int(nbytes)

    for vid in order:
        if isinstance(vid, SourceId):
            shardings[vid] = plan.get(vid) or seed_sharding(
                specs.get(vid), mesh)
            continue
        if isinstance(vid, SinkId):
            shardings[vid] = shardings.get(graph.get_sink_dependency(vid))
            continue

        op = graph.get_operator(vid)
        deps = graph.get_dependencies(vid)
        label = _label(graph, vid)
        anchor = f"{label}@{vid}"
        in_shardings = [shardings.get(d) for d in deps]
        in_specs = [specs.get(d, UNKNOWN) for d in deps]
        out_spec = specs.get(vid)

        # the operator's hook: its demands and, optionally, its output
        assigned: Optional[ShardedValue] = None
        hook = getattr(op, "abstract_sharding", None)
        if hook is not None:
            try:
                res = hook(in_shardings, in_specs)
            except Exception as e:
                # loud: the default rule alone would drop the hook's
                # demand checks silently
                res = None
                diags.append(Diagnostic(
                    "KP605", Severity.WARNING,
                    f"abstract_sharding hook raised "
                    f"{type(e).__name__}: {e} — this stage's placement "
                    "demands were skipped (default propagation applied)",
                    vertex=vid, label=label))
            if isinstance(res, ShardedValue):
                res = ShardingResult(out=res)
            if isinstance(res, ShardingResult):
                assigned = res.out
                if assigned is not None:
                    problem = _sharded_value_problem(
                        assigned, out_spec, mesh)
                    if problem is not None:
                        diags.append(Diagnostic(
                            "KP605", Severity.ERROR,
                            f"abstract_sharding hook on this stage "
                            f"returned {spec_str(assigned)} but "
                            f"{problem}; the hook's placement is "
                            "ignored here",
                            vertex=vid, label=label))
                        assigned = None
                for i, demand in enumerate(res.demands):
                    if demand is None or i >= len(deps):
                        continue
                    dep_sv = in_shardings[i]
                    dep_spec = in_specs[i]
                    if dep_sv is None or not isinstance(dep_spec, DataSpec):
                        continue
                    lead = _leading_axis(dep_sv)
                    bad = (
                        demand == DEMAND_DATA_SHARDED
                        and lead != meshlib.DATA_AXIS
                        and data_shards > 1
                    ) or (
                        demand == DEMAND_REPLICATED
                        and dep_sv.max_shards(mesh) > 1
                    )
                    if bad:
                        if demand == DEMAND_REPLICATED:
                            cost = meshlib.collective_cost(
                                "all_gather", dep_spec.nbytes,
                                shards=dep_sv.max_shards(mesh), mesh=mesh)
                        else:
                            cost = meshlib.collective_cost(
                                "all_to_all", dep_spec.nbytes,
                                shards=max(dep_sv.max_shards(mesh),
                                           data_shards),
                                mesh=mesh)
                        add_cost(vid, cost.bytes_moved)
                        gather = cost.kind == "all_gather"
                        diags.append(Diagnostic(
                            "KP601", Severity.WARNING,
                            f"implicit reshard: dependency {i} "
                            f"({_label(graph, deps[i])}@{deps[i]}) arrives "
                            f"as {spec_str(dep_sv)} but this stage demands "
                            f"a {demand} layout — the run inserts "
                            f"{'an all-gather' if gather else 'an all-to-all'}"
                            f" of ≈{_fmt_bytes(cost.bytes_moved)} "
                            "at this boundary",
                            vertex=vid, label=label))

        # the planner's assignment is the decision: it replaces the
        # default rule and the pins on the vertices it covers
        planned = plan.get(vid)
        if planned is not None and isinstance(out_spec, DataSpec) \
                and is_known(out_spec.element) and out_spec.on_device:
            problem = _sharded_value_problem(planned, out_spec, mesh)
            if problem is not None:
                diags.append(Diagnostic(
                    "KP605", Severity.ERROR,
                    f"planner assignment {spec_str(planned)} on this "
                    f"stage but {problem}; the assignment is ignored "
                    "here",
                    vertex=vid, label=label))
                planned = None
        else:
            planned = None
        if planned is not None:
            assigned = planned

        if assigned is None:
            assigned = _default_out_sharding(
                op, out_spec, in_shardings, in_specs, mesh)

        # the pins (first matching rule wins); host values take no
        # device placement
        if planned is None and isinstance(out_spec, DataSpec) \
                and is_known(out_spec.element) and out_spec.on_device:
            for rule in rules:
                if not rule.matches(label, anchor):
                    continue
                problem = _spec_problem(rule.spec, out_spec, mesh)
                if problem is not None:
                    diags.append(Diagnostic(
                        "KP605", Severity.ERROR,
                        f"partition rule {rule.pattern!r} pins "
                        f"{rule.spec} on this stage but {problem}; the "
                        "rule is ignored here",
                        vertex=vid, label=label))
                    break
                pinned = ShardedValue(
                    tree_map(lambda l: rule.spec, out_spec.element),
                    kind=out_spec.kind)
                if assigned is not None and not _same_placement(
                        assigned, pinned):
                    cost = meshlib.collective_cost(
                        "all_to_all", out_spec.nbytes,
                        shards=max(assigned.max_shards(mesh),
                                   pinned.max_shards(mesh),
                                   data_shards),
                        mesh=mesh)
                    add_cost(vid, cost.bytes_moved)
                    diags.append(Diagnostic(
                        "KP601", Severity.WARNING,
                        f"implicit reshard: propagation gives this stage "
                        f"{spec_str(assigned)} but partition rule "
                        f"{rule.pattern!r} pins {spec_str(pinned)} — the "
                        f"boundary moves ≈{_fmt_bytes(cost.bytes_moved)} "
                        "(all-to-all) to honor the rule",
                        vertex=vid, label=label))
                assigned = pinned
                break

        shardings[vid] = assigned

        # KP603: sharded data gathered into a host stage
        if _is_host_stage(graph, vid, specs):
            gathered = 0
            for d, dep_sv, dep_spec in zip(deps, in_shardings, in_specs):
                if dep_sv is None or not isinstance(dep_spec, DataSpec):
                    continue
                if dep_sv.max_shards(mesh) > 1 and dep_spec.nbytes:
                    cost = meshlib.collective_cost(
                        "all_gather", dep_spec.nbytes,
                        shards=dep_sv.max_shards(mesh), mesh=mesh)
                    gathered += cost.bytes_moved
                    diags.append(Diagnostic(
                        "KP603", Severity.WARNING,
                        f"host-code stage consumes device-sharded "
                        f"{_label(graph, d)}@{d} ({spec_str(dep_sv)}): "
                        f"every shard all-gathers to the host "
                        f"(≈{_fmt_bytes(cost.bytes_moved)}); keep the "
                        "stage on device or reshard explicitly",
                        vertex=vid, label=label))
            add_cost(vid, gathered)

        # KP602: a large operand held replicated though shardable
        if assigned is not None and isinstance(out_spec, DataSpec):
            total = out_spec.nbytes
            if total and total >= replicated_threshold_bytes \
                    and assigned.max_shards(mesh) <= 1:
                axis = _shardable_axis(out_spec, mesh)
                if axis is not None:
                    diags.append(Diagnostic(
                        "KP602", Severity.WARNING,
                        f"{_fmt_bytes(total)} held replicated on every "
                        f"device although the {axis!r} mesh axis divides "
                        "one of its dimensions — a sharded placement "
                        "exists (pin one with a PartitionRule or an "
                        "abstract_sharding hook)",
                        vertex=vid, label=label))

        # KP604: the data shards do not divide the example count
        if assigned is not None and assigned.kind == "dataset" \
                and _leading_axis(assigned) == meshlib.DATA_AXIS \
                and isinstance(out_spec, DataSpec) \
                and out_spec.count and data_shards > 1 \
                and out_spec.count % data_shards != 0 \
                and out_spec.count not in flagged_counts:
            flagged_counts.add(out_spec.count)
            diags.append(Diagnostic(
                "KP604", Severity.WARNING,
                f"{data_shards} data shards do not divide the propagated "
                f"example count {out_spec.count}: placement pads to "
                f"{-(-out_spec.count // data_shards) * data_shards} rows, "
                "so per-device shapes differ from same-pipeline stages "
                "at other counts and every distinct residue recompiles",
                vertex=vid, label=label))

    return shardings, diags, boundary


def _unknown_axes_problem(spec, mesh) -> Optional[str]:
    unknown = [ax for ax in meshlib.spec_axes(spec) if ax not in mesh.shape]
    if unknown:
        names = ", ".join(repr(a) for a in sorted(set(unknown)))
        return (f"the current mesh (axes {tuple(mesh.axis_names)}) has "
                f"no axis {names}")
    return None


def _spec_problem(spec, out_spec: DataSpec, mesh) -> Optional[str]:
    """Why one spec cannot apply to this stage's value (`:528-547`):
    every named axis must exist on the mesh, and the spec may not have
    more entries than the value's batch-level rank."""
    problem = _unknown_axes_problem(spec, mesh)
    if problem is not None:
        return problem
    n_entries = len(tuple(spec))
    extra = 1 if out_spec.kind == "dataset" else 0
    min_rank = min((len(_shape(l)) + extra
                    for l in tree_leaves(out_spec.element)), default=0)
    if n_entries > min_rank:
        return (f"the value's rank is {min_rank} (batch axis included) — "
                f"fewer than the spec's {n_entries} entries")
    return None


def _sharded_value_problem(sv: ShardedValue, out_spec,
                           mesh) -> Optional[str]:
    """KP605 for a hook's or a plan's placement (`:555-580`), leaf by
    leaf where the element is known."""
    for lspec in sv.leaf_specs():
        problem = _unknown_axes_problem(lspec, mesh)
        if problem is not None:
            return problem
    if not isinstance(out_spec, DataSpec) or not is_known(out_spec.element):
        return None
    leaves = tree_leaves(out_spec.element)
    leaf_specs = sv.leaf_specs()
    if len(leaves) != len(leaf_specs):
        return None
    extra = 1 if sv.kind == "dataset" else 0
    for leaf, lspec in zip(leaves, leaf_specs):
        rank = len(_shape(leaf)) + extra
        if len(tuple(lspec)) > rank:
            return (f"a leaf's rank is {rank} (batch axis included) — "
                    f"fewer than its spec's {len(tuple(lspec))} entries")
    return None


def _same_placement(a: ShardedValue, b: ShardedValue) -> bool:
    la, lb = a.leaf_specs(), b.leaf_specs()
    if len(la) != len(lb):
        return False
    return all(meshlib.specs_equal(x, y) for x, y in zip(la, lb))


def _shardable_axis(spec: DataSpec, mesh) -> Optional[str]:
    """A mesh axis of more than one device dividing some dimension of
    the value, the model axis first (`:590-604`)."""
    dims: List[int] = []
    if spec.kind == "dataset" and spec.count:
        dims.append(int(spec.count))
    for leaf in tree_leaves(spec.element):
        dims.extend(int(s) for s in _shape(leaf))
    for ax in (meshlib.MODEL_AXIS, meshlib.DATA_AXIS):
        n = int(mesh.shape.get(ax, 1))
        if n > 1 and any(d >= n and d % n == 0 for d in dims):
            return ax
    return None


def _default_out_sharding(op, out_spec, in_shardings, in_specs,
                          mesh) -> Optional[ShardedValue]:
    """The default rule (`:607-634`): data sharding survives a device
    stage fed data-sharded rows (the columns re-derived from the output
    element, as `Dataset` places them), replicated inputs stay
    replicated, a host input making a device dataset is placed fresh,
    and host or unknown outputs carry none."""
    if not isinstance(out_spec, DataSpec) or not is_known(out_spec.element) \
            or not out_spec.on_device:
        return None
    data_pairs = [(sv, s) for sv, s in zip(in_shardings, in_specs)
                  if isinstance(s, DataSpec)]
    if not data_pairs:
        return seed_sharding(out_spec, mesh)
    first_sv = data_pairs[0][0]
    if first_sv is None:
        return seed_sharding(out_spec, mesh)
    if out_spec.kind == "datum":
        return _replicated_like(out_spec)
    if _leading_axis(first_sv) == meshlib.DATA_AXIS:
        return seed_sharding(out_spec, mesh)
    return _replicated_like(out_spec)


# -------------------------------------------------------------- per-device


def _entry_shards(entry, mesh) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    n = 1
    for name in names:
        n *= int(mesh.shape.get(name, 1))
    return n


def per_device_bytes(spec: Any, sv: Optional[ShardedValue],
                     mesh) -> Optional[int]:
    """Bytes of this value on ONE card (`:652-687`), as the ranks hold
    it: each dimension padded up to a multiple of its axis factor before
    it is split (`Dataset` pads the rows to the data shards), so a
    shard's extent is ``ceil(dim / factor)``. Replicated leaves are
    charged whole, and so is a value of unknown placement."""
    if not isinstance(spec, DataSpec):
        return None
    total = spec.nbytes
    if total is None:
        return None
    if sv is None:
        return total
    mesh = meshlib.layout_of(mesh)
    leaves = tree_leaves(spec.element)
    leaf_specs = sv.leaf_specs()
    if len(leaves) != len(leaf_specs):
        return total
    count = spec.count if spec.kind == "dataset" else None
    if spec.kind == "dataset" and count is None:
        return total
    out = 0
    for leaf, lspec in zip(leaves, leaf_specs):
        dims = list(_shape(leaf))
        if spec.kind == "dataset":
            dims = [int(count)] + dims
        entries = list(lspec) + [None] * (len(dims) - len(lspec))
        per_dev = int(leaf.dtype.itemsize)
        for dim, entry in zip(dims, entries):
            factor = max(1, _entry_shards(entry, mesh))
            per_dev *= -(-int(dim) // factor)
        out += per_dev
    return out


def per_device_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    shardings: Dict[GraphId, Optional[ShardedValue]],
    memory: MemoryEstimate,
    *,
    mesh=None,
    hbm_budget_bytes: Optional[int] = None,
) -> Tuple[Dict[NodeId, Optional[int]], List[Diagnostic]]:
    """The memory model's live set scaled to ONE card's residency and
    held to the per-card budget (KP600, `:690-743`; it takes KP202's
    place at the full tier: on a sharded mesh the fleet's sum is not
    what any card's allocator sees). Each node's residency (streaming
    discounts included) is scaled by its own sharded share; the live-set
    walk is the memory pass's. The results land on ``memory``
    (``per_device``, ``per_device_peak_bytes``, ``per_device_peak_at``)."""
    mesh = meshlib.layout_of(mesh)
    diags: List[Diagnostic] = []
    order, _ = toposort(graph)

    per_dev: Dict[NodeId, Optional[int]] = {}
    for vid in memory.per_node:
        full = memory.per_node.get(vid)
        resident = memory.resident.get(vid)
        if full is None or resident is None or full <= 0:
            per_dev[vid] = resident
            continue
        pd_full = per_device_bytes(specs.get(vid), shardings.get(vid), mesh)
        if pd_full is None:
            per_dev[vid] = resident
            continue
        per_dev[vid] = int(resident * (pd_full / full))

    peak, peak_at = live_set_walk(graph, order, per_dev)
    memory.per_device = per_dev
    memory.per_device_peak_bytes = peak
    memory.per_device_peak_at = peak_at

    if hbm_budget_bytes and peak > hbm_budget_bytes:
        label = _label(graph, peak_at) if peak_at is not None else ""
        diags.append(Diagnostic(
            "KP600", Severity.WARNING,
            f"peak PER-DEVICE live memory {_fmt_bytes(peak)} exceeds the "
            f"{_fmt_bytes(hbm_budget_bytes)} per-device HBM budget (peak "
            f"at {label}@{peak_at}, {mesh.size} device(s) on the mesh)",
            vertex=peak_at, label=label))
    return per_dev, diags


# ------------------------------------------------------------ explanation


def explain_rows(
    graph: Graph,
    specs: Dict[GraphId, Any],
    shardings: Dict[GraphId, Optional[ShardedValue]],
    boundary: Dict[NodeId, int],
    per_device: Dict[NodeId, Optional[int]],
) -> List[Dict[str, Any]]:
    """One row a stage in topological order (`:749-771`): its spec,
    per-device bytes and priced boundary bytes, JSON-ready."""
    order, _ = toposort(graph)
    rows = []
    for vid in order:
        if not isinstance(vid, NodeId):
            continue
        rows.append({
            "vertex": vid.id,
            "label": _label(graph, vid),
            "spec": spec_str(shardings.get(vid)),
            "per_device_bytes": per_device.get(vid),
            "boundary_bytes": boundary.get(vid, 0),
        })
    return rows


def format_explain(rows: List[Dict[str, Any]]) -> str:
    lines = [f"{'stage':<44} {'spec':<24} {'per-dev':>10} {'boundary':>10}"]
    for r in rows:
        pd = _fmt_bytes(r["per_device_bytes"]) \
            if r["per_device_bytes"] is not None else "?"
        bd = _fmt_bytes(r["boundary_bytes"]) if r["boundary_bytes"] else "—"
        name = f"{r['label']}@{r['vertex']}"
        lines.append(f"{name[:44]:<44} {r['spec'][:24]:<24} "
                     f"{pd:>10} {bd:>10}")
    return "\n".join(lines)

