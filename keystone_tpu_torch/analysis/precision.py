"""The precision planner: each stage boundary's storage dtype as an
optimizer decision.

Counterpart of `keystone_tpu/analysis/precision.py:1-918`. Per stage
boundary a menu of legal storage policies, priced by the bytes the
boundary moves, solved by a chain DP with one bounded descent sweep,
and enforced by `workflow/optimizer.py::PrecisionPlannerRule` as casts
between the stages of a fused program (`nodes/util/fusion.py`):

  - **policies**: ``bf16`` (bf16 storage: halves every float32 byte the
    boundary moves), ``f32_bf16`` (f32 storage, bf16 matmul operands;
    byte-neutral, never chosen by the byte objective) and ``f32`` (the
    reference, always legal, what runs with the planner off);
  - **legality**: from each operator's ``precision_tolerance``
    declaration (``"tolerant"``, ``"compute"``, ``"exact"``); an
    undeclared stage is probed by running its body on a bf16 element of
    meta tensors (`specs.trace_element`): a run that fails, or an output
    that is not floating, pins it exact. ``precision_passthrough``
    stages (caches, combiners, identity) are looked through, and a
    boundary feeding a sink stays f32;
  - **cost**: `policy_nbytes` halves float32 leaves under bf16 (integer
    leaves keep their width); every storage flip on an edge pays
    `CAST_PENALTY_BYTES`, so a downcast undone at once never wins.

The plan never loses to the all-f32 default: both are scored by the
same function, and without a strict win the plan is the default.
Everything here is spec arithmetic on meta tensors: no data moves, no
device memory is taken. The KP70x lints are `precision_pass`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..workflow.graph import Graph, GraphId, NodeId, SinkId
from .diagnostics import Diagnostic, Severity
from .memory import _fmt_bytes, memory_pass
from .propagate import _label, toposort
from .specs import (
    UNKNOWN,
    DataSpec,
    ShapeDtype,
    TransformerSpec,
    dtype_name,
    is_known,
    trace_element,
    tree_leaves,
    tree_map,
)

# ------------------------------------------------------------------ policies

#: f32 storage, full-precision compute: the reference policy
POLICY_F32 = "f32"
#: f32 storage, bf16 matmul operands: byte-neutral, compute only
POLICY_F32_BF16 = "f32_bf16"
#: bf16 storage: halves every float32 byte the boundary moves
POLICY_BF16 = "bf16"
POLICIES: Tuple[str, ...] = (POLICY_F32, POLICY_F32_BF16, POLICY_BF16)

#: `precision_tolerance` declaration values
TOLERANT = "tolerant"   # bf16 storage and bf16 compute acceptable
COMPUTE = "compute"     # f32 storage required; bf16 matmul acceptable
EXACT = "exact"         # f32 storage and full-precision compute

#: the band policy-on outputs are held to against the f32 reference:
#: about two bf16 roundings of relative error, and an absolute floor for
#: near-zero rectified values (`:93-99`)
DEFAULT_BAND_RTOL = 2e-2
DEFAULT_BAND_ATOL = 5e-2

#: bytes charged per storage flip on an edge: a single halved boundary
#: between f32 neighbours must save more than two casts' worth
CAST_PENALTY_BYTES = 2 << 10

_STORAGE = {POLICY_F32: "float32", POLICY_F32_BF16: "float32",
            POLICY_BF16: "bfloat16"}


def storage_dtype(policy: str) -> Optional[str]:
    """The storage dtype name a policy gives float32 leaves; None keeps
    the propagated dtype."""
    name = _STORAGE[policy]
    return None if name == "float32" else name


def compute_precision(policy: str) -> Optional[str]:
    """The matmul scope a policy implies (``"bfloat16"``), or None."""
    return "bfloat16" if policy == POLICY_F32_BF16 else None


# ----------------------------------------------------------------- tolerance


def declared_tolerance(op) -> Optional[str]:
    tol = getattr(op, "precision_tolerance", None)
    if tol in (TOLERANT, COMPUTE, EXACT):
        return tol
    return None


def _float32_leaves(element) -> List[ShapeDtype]:
    if not is_known(element):
        return []
    return [leaf for leaf in tree_leaves(element)
            if isinstance(leaf, ShapeDtype) and leaf.dtype == torch.float32]


def cast_element(element, dtype_name_: str):
    """The element with every float32 leaf re-typed ``dtype_name_``
    (labels, indices and masks are never touched)."""
    if not is_known(element):
        return element
    target = getattr(torch, dtype_name_)

    def one(leaf):
        if isinstance(leaf, ShapeDtype) and leaf.dtype == torch.float32:
            return ShapeDtype(leaf.shape, target)
        return leaf

    return tree_map(one, element)


def probe_tolerance(op, element) -> Tuple[str, str]:
    """``(tolerance, source)`` of one operator: its declaration where it
    has one, else the probe: its per-item body run on a bf16 element of
    meta tensors. A run that fails, or an output that is not floating,
    pins the stage exact."""
    tol = declared_tolerance(op)
    if tol is not None:
        return tol, "declared"
    fn = getattr(op, "single_transform", None)
    if fn is None or not is_known(element) or not _float32_leaves(element):
        return EXACT, "pinned"
    try:
        out = trace_element(lambda x: fn([x]),
                            (cast_element(element, "bfloat16"),))
    except Exception:
        return EXACT, "probe-pinned"
    if not is_known(out):
        return EXACT, "probe-pinned"
    leaves = tree_leaves(out)
    if leaves and all(leaf.dtype.is_floating_point for leaf in leaves
                      if isinstance(leaf, ShapeDtype)):
        return TOLERANT, "probed"
    return EXACT, "probe-pinned"


# -------------------------------------------------------------- byte pricing


def policy_nbytes(spec: Any, policy: str,
                  nominal_count: int = 1024) -> Optional[int]:
    """Bytes one boundary materializes under ``policy``: bf16 storage
    halves float32 leaves, every other dtype keeps its width; a nominal
    count where the spec has none."""
    if not isinstance(spec, DataSpec) or not is_known(spec.element):
        return None
    sd = storage_dtype(policy)
    element = spec.element if sd is None else cast_element(spec.element, sd)
    total = 0
    for leaf in tree_leaves(element):
        if not isinstance(leaf, ShapeDtype):
            return None
        total += leaf.nbytes
    if spec.kind == "datum":
        return total
    count = spec.count if spec.count else nominal_count
    return total * int(count)


# ------------------------------------------------------------------ the plan


@dataclass
class PrecisionPlan:
    """Per-stage boundary policies, the all-f32 default they were scored
    against and both priced byte totals. Without ``improved`` the
    policies are the default and nothing is enforced."""

    policies: Dict[GraphId, str]
    default_policies: Dict[GraphId, str]
    planned_cost_bytes: float
    default_cost_bytes: float
    planned_boundary: Dict[NodeId, int] = field(default_factory=dict)
    default_boundary: Dict[NodeId, int] = field(default_factory=dict)
    #: vid -> (tolerance, source) of every inspected stage
    tolerances: Dict[GraphId, Tuple[str, str]] = field(default_factory=dict)

    @property
    def improved(self) -> bool:
        return self.planned_cost_bytes < self.default_cost_bytes

    @property
    def savings_bytes(self) -> int:
        return max(0, int(self.default_cost_bytes - self.planned_cost_bytes))

    def changed_vertices(self) -> List[GraphId]:
        return [vid for vid, pol in sorted(
                    self.policies.items(),
                    key=lambda kv: getattr(kv[0], "id", -1))
                if self.default_policies.get(vid) != pol]

    def storage_for(self, vid) -> Optional[str]:
        pol = self.policies.get(vid)
        return storage_dtype(pol) if pol else None

    def retyped_specs(self, specs: Dict[GraphId, Any]) -> Dict[GraphId, Any]:
        """The specs with the chosen storage dtypes in their elements:
        what the memory model prices under this plan."""
        out = dict(specs)
        for vid, pol in self.policies.items():
            sd = storage_dtype(pol)
            spec = specs.get(vid)
            if sd is None or not isinstance(spec, DataSpec):
                continue
            out[vid] = DataSpec(
                element=cast_element(spec.element, sd), count=spec.count,
                kind=spec.kind, on_device=spec.on_device,
                streaming=spec.streaming)
        return out

    def rows(self, graph: Graph, specs: Dict[GraphId, Any]
             ) -> List[Dict[str, Any]]:
        """The per-stage table in topological order, JSON-ready."""
        order, _ = toposort(graph)
        rows = []
        for vid in order:
            if not isinstance(vid, NodeId):
                continue
            spec = specs.get(vid)
            if not isinstance(spec, DataSpec):
                continue
            pol = self.policies.get(vid, POLICY_F32)
            tol, source = self.tolerances.get(vid, (EXACT, "pinned"))
            default_b = self.default_boundary.get(vid)
            planned_b = self.planned_boundary.get(vid)
            rows.append({
                "vertex": vid.id,
                "label": _label(graph, vid),
                "policy": pol,
                "dtype": storage_dtype(pol) or _elem_dtype_name(spec),
                "tolerance": tol,
                "tolerance_source": source,
                "default_bytes": default_b,
                "planned_bytes": planned_b,
                "bytes_saved": (default_b - planned_b)
                if default_b is not None and planned_b is not None else 0,
                "changed": pol != self.default_policies.get(vid, POLICY_F32),
            })
        return rows


def _elem_dtype_name(spec: DataSpec) -> str:
    leaves = tree_leaves(spec.element) if is_known(spec.element) else []
    names = sorted({dtype_name(leaf.dtype) for leaf in leaves
                    if isinstance(leaf, ShapeDtype)})
    if not names:
        return "?"
    return names[0] if len(names) == 1 else "+".join(names)


def format_plan(rows: List[Dict[str, Any]]) -> str:
    lines = [f"{'stage':<40} {'dtype':<10} {'tolerance':<18} {'Δbytes':>12}"]
    for r in rows:
        mark = "*" if r["changed"] else " "
        name = f"{r['label']}@{r['vertex']}"
        delta = r["bytes_saved"]
        col = f"-{delta:,d}" if delta else "—"
        lines.append(
            f"{name[:40]:<40} {mark}{r['dtype'][:9]:<9} "
            f"{(r['tolerance'] + '/' + r['tolerance_source'])[:18]:<18} "
            f"{col:>12}")
    return "\n".join(lines)


# ------------------------------------------------------------------- solver


class _PrecisionModel:
    """The priced view of one graph: per-vertex menus (legality flowed
    through passthrough stages), boundary bytes by policy, and one
    scorer for the chosen plan and the default alike."""

    def __init__(self, graph: Graph, specs: Dict[GraphId, Any],
                 tolerances: Optional[Dict[GraphId, Tuple[str, str]]] = None):
        self.graph = graph
        self.specs = specs
        order, _ = toposort(graph)
        self.order = [v for v in order if not isinstance(v, SinkId)]
        known_counts = [
            s.count for s in specs.values()
            if isinstance(s, DataSpec) and s.kind == "dataset" and s.count
        ]
        self.nominal_count = max(known_counts, default=1024)
        # a caller holding a resolved map skips the probe for the
        # vertices it has
        self.tolerances: Dict[GraphId, Tuple[str, str]] = {}
        for vid in self.order:
            if isinstance(vid, NodeId):
                if tolerances is not None and vid in tolerances:
                    self.tolerances[vid] = tolerances[vid]
                else:
                    self.tolerances[vid] = self._tolerance(vid)
        #: vid -> legal policies, for vertices with a real choice
        self.menus: Dict[GraphId, Tuple[str, ...]] = {}
        for vid in self.order:
            menu = self._menu(vid)
            if len(menu) > 1:
                self.menus[vid] = menu

    def _tolerance(self, vid: NodeId) -> Tuple[str, str]:
        op = self.graph.get_operator(vid)
        deps = self.graph.get_dependencies(vid)
        in_spec = next(
            (self.specs.get(d) for d in deps
             if isinstance(self.specs.get(d), DataSpec)), None)
        element = in_spec.element if isinstance(in_spec, DataSpec) \
            else UNKNOWN
        return probe_tolerance(op, element)

    def _effective_consumers(self, vid, _seen=None) -> List[GraphId]:
        """Users of ``vid``, passthrough stages looked through."""
        _seen = _seen if _seen is not None else set()
        out: List[GraphId] = []
        for u in self.graph.users_of(vid):
            if u in _seen:
                continue
            _seen.add(u)
            if isinstance(u, NodeId) and getattr(
                    self.graph.get_operator(u),
                    "precision_passthrough", False):
                out.extend(self._effective_consumers(u, _seen))
            else:
                out.append(u)
        return out

    def _menu(self, vid) -> Tuple[str, ...]:
        if not isinstance(vid, NodeId):
            return (POLICY_F32,)
        spec = self.specs.get(vid)
        if not isinstance(spec, DataSpec) or spec.kind != "dataset" \
                or not spec.on_device or not is_known(spec.element) \
                or not _float32_leaves(spec.element):
            return (POLICY_F32,)
        tol, _ = self.tolerances.get(vid, (EXACT, "pinned"))
        if tol != TOLERANT:
            return (POLICY_F32,)
        for u in self._effective_consumers(vid):
            if isinstance(u, SinkId) or not isinstance(u, NodeId):
                return (POLICY_F32,)  # the pipeline's visible output
            u_tol, _ = self.tolerances.get(u, (EXACT, "pinned"))
            if u_tol != TOLERANT:
                return (POLICY_F32,)
        return (POLICY_F32, POLICY_BF16)

    def vbytes(self, vid, policy: str) -> Optional[int]:
        return policy_nbytes(self.specs.get(vid), policy,
                             self.nominal_count)

    def score(self, policies: Dict[GraphId, str]) -> Tuple[
            float, Dict[NodeId, int]]:
        """``(objective, boundary)``: boundary bytes per vertex under the
        assignment plus the cast penalty per storage flip edge."""
        objective = 0.0
        boundary: Dict[NodeId, int] = {}

        def stor(v) -> str:
            return _STORAGE[policies.get(v, POLICY_F32)]

        for vid in self.order:
            if not isinstance(vid, NodeId):
                continue
            nbytes = self.vbytes(vid, policies.get(vid, POLICY_F32))
            spec = self.specs.get(vid)
            if nbytes is not None and isinstance(spec, DataSpec) \
                    and spec.kind == "dataset" and spec.on_device \
                    and is_known(spec.element):
                objective += nbytes
                boundary[vid] = int(nbytes)
            for d in self.graph.get_dependencies(vid):
                if isinstance(self.specs.get(d), DataSpec) \
                        and stor(d) != stor(vid) \
                        and (d in self.menus or vid in self.menus):
                    objective += CAST_PENALTY_BYTES
        return objective, boundary


def _plan_path(saved: List[Optional[int]], legal: List[bool]) -> List[bool]:
    """The exact chain solution over one fan-out-free path of
    boundaries: a maximal legal run is kept iff the bytes it saves
    exceed its two casts."""
    out = [False] * len(saved)
    i = 0
    while i < len(saved):
        if not legal[i] or not saved[i]:
            i += 1
            continue
        j = i
        total = 0
        while j < len(saved) and legal[j] and saved[j]:
            total += saved[j]
            j += 1
        if total > 2 * CAST_PENALTY_BYTES:
            for k in range(i, j):
                out[k] = True
        i = j
    return out


def plan_precision(graph: Graph, specs: Dict[GraphId, Any]
                   ) -> Optional[PrecisionPlan]:
    """Boundary policies that minimize the priced bytes, or None where
    no tolerant float boundary exists; ``improved`` says whether they
    beat the all-f32 default."""
    model = _PrecisionModel(graph, specs)
    if not model.menus:
        return None
    default = {vid: POLICY_F32 for vid in model.menus}
    default_obj, default_boundary = model.score(default)

    # maximal fan-out-free chains of choosable vertices, solved exactly
    users = {vid: [u for u in graph.users_of(vid)
                   if not isinstance(u, SinkId)]
             for vid in model.order}
    chosen: Dict[GraphId, str] = dict(default)
    visited: set = set()
    for vid in model.order:
        if vid not in model.menus or vid in visited:
            continue
        head = vid
        while True:
            deps = [d for d in graph.get_dependencies(head)
                    if d in model.menus]
            if len(deps) == 1 and len(users.get(deps[0], ())) == 1 \
                    and deps[0] not in visited:
                head = deps[0]
            else:
                break
        chain = [head]
        cur = head
        while True:
            kids = [u for u in users.get(cur, ())
                    if isinstance(u, NodeId) and u in model.menus]
            if len(users.get(cur, ())) == 1 and len(kids) == 1 \
                    and kids[0] not in visited:
                chain.append(kids[0])
                cur = kids[0]
            else:
                break
        visited.update(chain)
        saved = []
        legal = []
        for v in chain:
            f32_b = model.vbytes(v, POLICY_F32)
            bf16_b = model.vbytes(v, POLICY_BF16)
            saved.append((f32_b - bf16_b)
                         if f32_b is not None and bf16_b is not None
                         else None)
            legal.append(POLICY_BF16 in model.menus[v])
        for v, keep in zip(chain, _plan_path(saved, legal)):
            if keep:
                chosen[v] = POLICY_BF16

    # one bounded descent: the other policy at each vertex, strict
    # improvements kept
    best_obj, _ = model.score(chosen)
    for _sweep in range(2):
        changed = False
        for vid in model.menus:
            for pol in model.menus[vid]:
                if pol == chosen[vid]:
                    continue
                trial = dict(chosen)
                trial[vid] = pol
                trial_obj, _ = model.score(trial)
                if trial_obj < best_obj:
                    chosen, best_obj = trial, trial_obj
                    changed = True
        if not changed:
            break

    planned_obj, planned_boundary = model.score(chosen)
    if not planned_obj < default_obj:
        chosen = dict(default)
        planned_obj, planned_boundary = default_obj, default_boundary
    return PrecisionPlan(
        policies=chosen,
        default_policies=default,
        planned_cost_bytes=planned_obj,
        default_cost_bytes=default_obj,
        planned_boundary=planned_boundary,
        default_boundary=default_boundary,
        tolerances=dict(model.tolerances),
    )


# ----------------------------------------------- fused-program stage trails


def stage_tolerance(stage, graph: Graph = None, vid: NodeId = None,
                    slot_index: int = None) -> str:
    """Tolerance of one fused-program stage: a fit slot reads the
    estimator that fills it (undeclared: exact), a stage its own
    declaration (undeclared: exact)."""
    from ..workflow.fusion_rule import _FitSlot

    if isinstance(stage, _FitSlot):
        if graph is None or vid is None:
            return EXACT
        deps = graph.get_dependencies(vid)
        if stage.index >= len(deps) or not isinstance(
                deps[stage.index], NodeId):
            return EXACT
        est_op = graph.get_operator(deps[stage.index])
        return declared_tolerance(est_op) or EXACT
    return declared_tolerance(stage) or EXACT


def stage_policy_menu(saved: List[Optional[int]],
                      legal: List[bool]) -> List[Dict[str, Any]]:
    """One entry per maximal legal bf16 run `_plan_path` decides over:
    the bytes it would save, the cast penalty it must clear, and whether
    it was kept (the ledger's alternatives)."""
    menu: List[Dict[str, Any]] = []
    i = 0
    while i < len(saved):
        if not legal[i] or not saved[i]:
            i += 1
            continue
        j = i
        total = 0
        while j < len(saved) and legal[j] and saved[j]:
            total += saved[j]
            j += 1
        menu.append({
            "entry": f"bf16_boundaries_{i}..{j - 1}",
            "bytes_saved": int(total),
            "cast_penalty_bytes": 2 * CAST_PENALTY_BYTES,
            "kept": total > 2 * CAST_PENALTY_BYTES,
        })
        i = j
    return menu


def plan_stage_precision(
    graph: Graph,
    vid: NodeId,
    op,
    specs: Dict[GraphId, Any],
) -> Optional[Tuple[Tuple[Optional[str], ...], int, List[Dict[str, Any]]]]:
    """``(storage_names, savings_bytes, menu)`` of one fused program:
    ``storage_names[i]`` is the dtype name stage ``i``'s output is cast
    to (None: untouched), aligned with the peepholed stage list; the
    final entry restores the program's output dtype. None where the
    trail cannot be priced or saves nothing."""
    from ..nodes.util.fusion import _peephole
    from ..workflow.fusion_rule import _FitSlot

    stage_specs = getattr(op, "stage_specs", None)
    if stage_specs is None:
        stage_specs = list(getattr(op, "stages", []))
    stages = _peephole(list(stage_specs))
    deps = graph.get_dependencies(vid)
    if not deps:
        return None
    # a chain's data input is its last dependency, a fused
    # transformer's its only one
    data_spec = specs.get(deps[-1])
    if not isinstance(data_spec, DataSpec) or not is_known(
            data_spec.element) or data_spec.kind != "dataset":
        return None
    count = data_spec.count or 1024
    t_specs = [specs.get(d) for d in deps[:-1]]

    elem = data_spec.element
    # saved_bytes[i]: what halving stage i's output saves over the
    # dataset; restore_names[i]: that boundary's own single-leaf
    # floating dtype (the cast that re-asserts it), else None
    saved_bytes: List[Optional[int]] = []
    restore_names: List[Optional[str]] = []
    tols: List[str] = []
    for s in stages:
        tols.append(stage_tolerance(s, graph, vid))
        if not is_known(elem):
            return None
        try:
            if isinstance(s, _FitSlot):
                ts = t_specs[s.index] if s.index < len(t_specs) else None
                elem = (ts.apply_element(elem)
                        if isinstance(ts, TransformerSpec) else UNKNOWN)
            else:
                elem = trace_element(
                    lambda x, s=s: s.single_transform([x]), (elem,))
        except Exception:
            return None
        if not is_known(elem):
            return None
        f32_leaves = _float32_leaves(elem)
        saved = sum(leaf.size * 2 for leaf in f32_leaves)
        saved_bytes.append(saved * count if f32_leaves else None)
        leaves = tree_leaves(elem)
        restore_names.append(
            dtype_name(leaves[0].dtype)
            if len(leaves) == 1 and isinstance(leaves[0], ShapeDtype)
            and leaves[0].dtype.is_floating_point else None)

    # boundary i sits between stages i and i+1: bf16 only where both
    # tolerate it; the program's output boundary is never reduced
    n = len(stages)
    legal = [
        tols[i] == TOLERANT and tols[i + 1] == TOLERANT
        and saved_bytes[i] is not None
        for i in range(n - 1)
    ] + [False]
    keep = _plan_path(saved_bytes, legal)
    menu = stage_policy_menu(saved_bytes, legal)

    # every kept run is restored at its exit boundary: the stages follow
    # their input dtype, so without an up-cast bf16 would flow on into
    # exact stages; a run whose exit cannot be restored is dropped
    storage: List[Optional[str]] = [None] * n
    savings = 0
    i = 0
    while i < n - 1:
        if not keep[i]:
            i += 1
            continue
        j = i
        while j < n - 1 and keep[j]:
            j += 1
        exit_restore = restore_names[j]
        if exit_restore is not None:
            for k in range(i, j):
                storage[k] = "bfloat16"
                savings += saved_bytes[k] or 0
            storage[j] = exit_restore
        else:
            for entry in menu:
                if entry["entry"] == f"bf16_boundaries_{i}..{j - 1}":
                    entry["kept"] = False
                    entry["dropped"] = "unrestorable_exit_boundary"
        i = j
    # always re-assert the program's visible output dtype where known
    if storage[n - 1] is None:
        storage[n - 1] = restore_names[n - 1]
    if not savings:
        return None
    return tuple(storage), int(savings), menu


# ------------------------------------------------------------------- lints


def precision_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    plan: Optional[PrecisionPlan] = None,
) -> List[Diagnostic]:
    """Lint a chosen or hand-written precision plan:

      - KP701 (ERROR): a reduced-precision policy on a boundary whose
        producer, or (for a storage policy) an effective consumer, is
        not tolerant;
      - KP702 (WARNING): cast-thrash, a bf16 boundary whose consumers
        all store f32 and whose halving does not cover the two casts.

    KP703 is `reprice_memory`'s."""
    if plan is None:
        return []
    diags: List[Diagnostic] = []
    model = _PrecisionModel(graph, specs, tolerances=plan.tolerances)
    for vid, pol in sorted(plan.policies.items(),
                           key=lambda kv: getattr(kv[0], "id", -1)):
        if pol in (None, POLICY_F32) or not isinstance(vid, NodeId):
            continue
        label = _label(graph, vid)
        tol, source = model.tolerances.get(vid, (EXACT, "pinned"))
        bad = tol != TOLERANT
        bad_consumer = None
        # a compute-only policy leaves the stored bytes f32: only the
        # stage itself must tolerate it
        if storage_dtype(pol) is not None:
            for u in model._effective_consumers(vid):
                if isinstance(u, SinkId) or not isinstance(u, NodeId):
                    bad_consumer = u
                    break
                u_tol, _ = model.tolerances.get(u, (EXACT, "pinned"))
                if u_tol != TOLERANT:
                    bad_consumer = u
                    break
        if bad or bad_consumer is not None:
            who = ("this stage declares/probes "
                   f"{tol!r} ({source})" if bad else
                   f"consumer {_label(graph, bad_consumer)}@{bad_consumer} "
                   "does not tolerate reduced precision")
            diags.append(Diagnostic(
                "KP701", Severity.ERROR,
                f"precision policy {pol!r} on an intolerant boundary: "
                f"{who}; the policy would silently degrade an exact "
                "stage's inputs",
                vertex=vid, label=label))
            continue
        if storage_dtype(pol) is None:
            continue
        f32_b = model.vbytes(vid, POLICY_F32)
        bf16_b = model.vbytes(vid, POLICY_BF16)
        saved = (f32_b - bf16_b) if f32_b and bf16_b else 0
        consumers = [u for u in model._effective_consumers(vid)
                     if isinstance(u, NodeId)]
        undone = consumers and all(
            storage_dtype(plan.policies.get(u, POLICY_F32)) is None
            for u in consumers)
        if undone and saved <= 2 * CAST_PENALTY_BYTES:
            diags.append(Diagnostic(
                "KP702", Severity.WARNING,
                f"cast-thrash: this boundary stores bf16 but every "
                f"consumer's boundary is f32 and the halving saves only "
                f"{_fmt_bytes(int(saved))}, less than the two casts the "
                "flip pair costs; drop the policy here",
                vertex=vid, label=label))
    return diags


def reprice_memory(
    graph: Graph,
    specs: Dict[GraphId, Any],
    plan: PrecisionPlan,
    **memory_kwargs,
) -> Tuple[Any, Any, List[Diagnostic]]:
    """The memory model run again under the chosen storage dtypes:
    ``(default_estimate, planned_estimate, diags)``, a KP703 INFO for
    each stage whose residency the plan changed."""
    est0, _ = memory_pass(graph, specs, **memory_kwargs)
    est1, _ = memory_pass(graph, plan.retyped_specs(specs),
                          **memory_kwargs)
    diags: List[Diagnostic] = []
    for vid in sorted(est0.resident, key=lambda v: v.id):
        a, b = est0.resident.get(vid), est1.resident.get(vid)
        if a and b and a != b:
            diags.append(Diagnostic(
                "KP703", Severity.INFO,
                f"dtype-aware re-pricing: residency {_fmt_bytes(a)} → "
                f"{_fmt_bytes(b)} under the chosen precision policy",
                vertex=vid, label=_label(graph, vid)))
    return est0, est1, diags


# ------------------------------------------------------------------ banding


def shrink_to_band(
    plan: PrecisionPlan,
    evaluate: Callable[[PrecisionPlan], bool],
    rescore: Optional[Callable[[Dict[GraphId, str]],
                               Tuple[float, Dict[NodeId, int]]]] = None,
) -> PrecisionPlan:
    """Revert changed boundaries, the largest saving first, until
    ``evaluate`` (a band check) passes; the all-f32 default always
    does. ``rescore`` (a `_PrecisionModel.score`) keeps the cost exact,
    cast penalties included."""
    current = plan
    while not evaluate(current):
        changed = current.changed_vertices()
        if not changed:
            return current
        worst = max(
            changed,
            key=lambda v: current.default_boundary.get(v, 0)
            - current.planned_boundary.get(v, 0))
        policies = dict(current.policies)
        policies[worst] = current.default_policies.get(worst, POLICY_F32)
        if rescore is not None:
            cost, planned_boundary = rescore(policies)
        else:
            cost = current.planned_cost_bytes + (
                current.default_boundary.get(worst, 0)
                - current.planned_boundary.get(worst, 0))
            planned_boundary = dict(current.planned_boundary)
            planned_boundary[worst] = current.default_boundary.get(worst, 0)
            if all(policies.get(v) == current.default_policies.get(v)
                   for v in policies):
                cost = current.default_cost_bytes
        current = PrecisionPlan(
            policies=policies,
            default_policies=current.default_policies,
            planned_cost_bytes=cost,
            default_cost_bytes=current.default_cost_bytes,
            planned_boundary=planned_boundary,
            default_boundary=current.default_boundary,
            tolerances=current.tolerances,
        )
    return current
