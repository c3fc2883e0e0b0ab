"""The unified plan optimizer: one decision over the storage dtypes, the
chunk size, the cache points, the chain kernels and the spills.

Counterpart of `keystone_tpu/analysis/plan_ir.py:1-1181`. Per choosable
boundary a product menu

    {placement family (`planner.py`'s menu on a layout of more than
       one card: the sharding planner's choice set; none on one card)
     × storage dtype (`precision.py`'s boundary policies, and inside a
       fused program the per-trail `plan_stage_precision` decision)
     × cache point (`autocache.AutoCacheRule._candidates`: demanded more
       than once, not cached yet), on the card or in host memory}

plus one plan-level axis, the chunk size from `CHUNK_LADDER`, plus one
per fused program: run a KP801 candidate's stage slice as one chain
kernel (K4, `ops/chain_kernels.py`) or one launch a stage.

Every assignment is priced in seconds by one time model:

  - each stage `roofline.stage_cost(flops, bytes)` with the boundary
    bytes its dtypes move (`precision.policy_nbytes`), on the card's
    calibrated rates (`calibrate.machine_rates`) unless a `Machine` is
    given;
  - the collectives of family flips, unmet ``abstract_sharding``
    demands and host gathers, in the sharding planner's own formulas
    (`planner.transition_cost`, `demand_cost`, `gather_cost`) at the
    bytes the chosen dtypes move, and a family whose per-card residency
    busts the budget as INF (none on one card);
  - `roofline.DISPATCH_OVERHEAD_S` per chunk trip, which makes the chunk
    a real decision;
  - the casts each storage flip costs;
  - each stage times its recomputations under the chosen cache points
    (`autocache.get_runs`);
  - a spilled cache's eviction and reloads over the host link's
    calibrated rate (`calibrate.host_bandwidth`) plus a dispatch per
    window trip.

``hbm_budget_bytes`` is a hard constraint: caches whose pinned bytes,
or a chunk whose in-flight rows, do not fit price INF. A spilled cache
pins two windows, not its bytes, which is how a budget the device cache
busts becomes feasible. The sequential composition (the precision
rule's trails, the config's chunk, no caches) is always scored by the
same function, so the joint plan never loses to it: ``improved`` is a
strict win, or the plan is the sequential one.

The kernel axis prices both sides as JAX's does (the slice at one pass
over device memory against a round trip a boundary) and takes a slice's
feasibility from `ops/chain_kernels.py`: `lowerability` and the
`ChainPlan` layout, which fails where a row's step does not fit a
block's shared memory (JAX's `analysis/kernels.py` proofs are about
Mosaic's VMEM and have no counterpart). The chosen slice equals
`plan_chain_kernel`'s tag, which each fused transformer sets on itself
(`nodes/util/fusion.py`).

Spec arithmetic only: no data moves, no device memory is taken.
Enforcement is `workflow/optimizer.py::UnifiedPlannerRule`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

from ..workflow.graph import Graph, GraphId, NodeId, SinkId
from ..parallel import mesh as meshlib
from .planner import (
    FAMILY_REPLICATED,
    ShardingPlan,
    _CostModel,
    demand_cost,
    family_shards,
    gather_cost,
    plan_sharding,
    transition_cost,
)
from .sharding import DEFAULT_REPLICATED_THRESHOLD
from .precision import (
    CAST_PENALTY_BYTES,
    POLICY_F32,
    _STORAGE,
    PrecisionPlan,
    _PrecisionModel,
    plan_precision,
    plan_stage_precision,
    policy_nbytes,
)
from .propagate import _label, toposort
from .roofline import (
    DISPATCH_OVERHEAD_S,
    Machine,
    default_machine,
    roofline_pass,
    stage_cost,
)
from .specs import DataSpec

_INF = float("inf")

#: the power-of-two ladder the chunk axis chooses from (`:108-111`): the
#: shapes the host batching's pad ladder already runs
CHUNK_LADDER: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def machine_from_weights(weights) -> Machine:
    """The `Machine` of cost weights: an object with ``peak_flops`` and
    ``peak_bw``, or `cost_model.resolve_weights`'s ``(seconds a FLOP,
    seconds a byte, ...)``. The seam through which measured weights
    reach the scorer."""
    if hasattr(weights, "peak_flops"):
        return Machine(float(weights.peak_flops), float(weights.peak_bw))
    return Machine(1.0 / float(weights[0]), 1.0 / float(weights[1]))


# ------------------------------------------------------------ assignment


@dataclass(frozen=True)
class Assignment:
    """One point of the joint decision space: per-vertex ``families``
    and ``policies``, per-program ``trails`` (bf16 trail on or off) and
    ``kernels`` (chain kernel on or off), the plan's ``chunk``, the
    ``caches`` and the host-placed ``spills`` among them."""

    families: Tuple[Tuple[Any, str], ...] = ()
    policies: Tuple[Tuple[Any, str], ...] = ()
    trails: Tuple[Tuple[Any, bool], ...] = ()
    chunk: int = 256
    caches: FrozenSet = frozenset()
    kernels: Tuple[Tuple[Any, bool], ...] = ()
    spills: FrozenSet = frozenset()

    def fam(self) -> Dict[Any, str]:
        return dict(self.families)

    def pol(self) -> Dict[Any, str]:
        return dict(self.policies)

    def trl(self) -> Dict[Any, bool]:
        return dict(self.trails)

    def krn(self) -> Dict[Any, bool]:
        return dict(self.kernels)


def _by_id(d: Dict) -> tuple:
    return tuple(sorted(d.items(), key=lambda kv: getattr(kv[0], "id", -1)))


def _assign(families: Dict, policies: Dict, trails: Dict, chunk: int,
            caches, kernels: Optional[Dict] = None,
            spills=frozenset()) -> Assignment:
    return Assignment(
        families=_by_id(families), policies=_by_id(policies),
        trails=_by_id(trails), chunk=int(chunk), caches=frozenset(caches),
        kernels=_by_id(kernels or {}), spills=frozenset(spills))


# ------------------------------------------------------------- the model


class _UnifiedModel:
    """The priced joint view of one graph, and the one scorer of every
    assignment (`:186-607`)."""

    def __init__(self, graph: Graph, specs: Dict[GraphId, Any], layout,
                 hbm_budget_bytes: Optional[int], chunk_default: int,
                 machine: Machine,
                 include_boundary_policies: bool = True,
                 precision_floor_bytes: int = 0,
                 allow_spill: bool = False):
        from ..workflow.autocache import AutoCacheRule, get_runs

        self.graph = graph
        self.specs = specs
        self.layout = meshlib.layout_of(layout)
        self.budget = hbm_budget_bytes
        self.chunk_default = int(chunk_default)
        self.machine = machine
        self.precision_floor_bytes = int(precision_floor_bytes)
        #: the spill axis (``ooc_spill``): off, no spill is scored
        self.allow_spill = bool(allow_spill)
        self._host_bw: Optional[float] = None
        self._get_runs = get_runs
        #: cache set -> recomputation counts (the descent scores a few
        #: cache sets many times)
        self._runs: Dict[FrozenSet, Dict] = {}
        order, _ = toposort(graph)
        self.order = [v for v in order if not isinstance(v, SinkId)]

        # compute: the roofline's FLOPs and reference bytes per stage
        self.roof, _ = roofline_pass(graph, specs, machine=machine,
                                     chunk_rows=chunk_default)
        self.unpriced_stages = self.roof.unknown_stages

        # placement (`:230-246`): on more than one card, the sharding
        # planner's choice set; none on one card
        self.pmodel: Optional[_CostModel] = None
        self.splan: Optional[ShardingPlan] = None
        self.fam_menus: Dict[Any, Tuple[str, ...]] = {}
        if self.layout.size > 1:
            self.splan = plan_sharding(graph, specs, mesh=self.layout,
                                       hbm_budget_bytes=hbm_budget_bytes)
            if self.splan is not None:
                self.pmodel = _CostModel(
                    graph, specs, self.layout, hbm_budget_bytes,
                    replicated_threshold_bytes=DEFAULT_REPLICATED_THRESHOLD)
                for vid in list(self.pmodel.menus):
                    if vid not in self.splan.families:
                        del self.pmodel.menus[vid]
                self.fam_menus = {vid: tuple(menu) for vid, menu in
                                  self.pmodel.menus.items()}

        # dtypes: graph-level boundary policies (reported, not enforced)
        # and per-program trails (enforced)
        self.prmodel: Optional[_PrecisionModel] = None
        self.pplan = None
        if include_boundary_policies:
            self.pplan = plan_precision(graph, specs)
            if self.pplan is not None:
                self.prmodel = _PrecisionModel(
                    graph, specs, tolerances=self.pplan.tolerances)
        self.program_trails: Dict[Any, Tuple] = {}
        from ..nodes.util.fusion import FusedBatchTransformer
        from ..workflow.fusion_rule import FusedChainOperator

        for vid in self.order:
            if not isinstance(vid, NodeId):
                continue
            op = graph.get_operator(vid)
            if isinstance(op, (FusedChainOperator, FusedBatchTransformer)) \
                    and getattr(op, "planned_precision", None) is None:
                try:
                    decided = plan_stage_precision(graph, vid, op, specs)
                except Exception:
                    decided = None
                if decided is not None:
                    self.program_trails[vid] = decided

        # kernels: the KP801 fused-trail candidates, one a vertex (the
        # largest saving); an infeasible one prices INF in the scorer
        self.kernel_candidates: Dict[Any, Dict[str, Any]] = {}
        for cand in self.roof.candidates:
            if cand.get("kind") != "fused_trail" \
                    or not cand.get("stage_slice"):
                continue
            kvid = cand["vertices"][0]
            prev = self.kernel_candidates.get(kvid)
            if prev is None or cand["seconds_saved"] > prev["seconds_saved"]:
                self.kernel_candidates[kvid] = cand
        for kvid, cand in self.kernel_candidates.items():
            cand["feasible"] = self._kernel_feasible(kvid, cand)

        # caches: the autocache candidates whose residency is priceable
        self.cache_candidates: List[Any] = []
        self._cache_bytes: Dict[Any, int] = {}
        try:
            candidates = AutoCacheRule._candidates(graph)
        except Exception:
            candidates = []
        counts = [s.count for s in specs.values()
                  if isinstance(s, DataSpec) and s.kind == "dataset"
                  and s.count]
        self.nominal_count = max(counts) if counts else 1024
        for vid in candidates:
            spec = specs.get(vid)
            nb = policy_nbytes(spec, POLICY_F32, self.nominal_count) \
                if isinstance(spec, DataSpec) else None
            if nb is not None and vid in self.roof.stages:
                self.cache_candidates.append(vid)
                self._cache_bytes[vid] = nb
        self._nbytes_cache: Dict[Tuple[Any, str], Optional[int]] = {}

    # ------------------------------------------------------------ pieces

    def host_bandwidth(self) -> float:
        """The host link's calibrated B/s, the spill tier's reload rate;
        read only when a spill is scored."""
        if self._host_bw is None:
            from ..nodes.learning.calibrate import host_bandwidth

            bw = float(host_bandwidth())
            self._host_bw = bw if bw > 0 else 1.0e10
        return self._host_bw

    def vbytes(self, vid, policy: str) -> Optional[int]:
        key = (vid, policy)
        if key not in self._nbytes_cache:
            self._nbytes_cache[key] = policy_nbytes(
                self.specs.get(vid), policy, self.nominal_count)
        return self._nbytes_cache[key]

    def _count(self, vid) -> int:
        st = self.roof.stages.get(vid)
        if st is not None and st.count:
            return int(st.count)
        spec = self.specs.get(vid)
        if isinstance(spec, DataSpec) and spec.count:
            return int(spec.count)
        return self.nominal_count

    def _data_dep(self, vid):
        if not isinstance(vid, NodeId):
            return None
        for d in self.graph.get_dependencies(vid):
            if isinstance(self.specs.get(d), DataSpec):
                return d
        return None

    def _kernel_feasible(self, vid, cand) -> Tuple[bool, str]:
        """The candidate slice's chain kernel lowers and its row fits a
        block's shared memory at the propagated item shape (`:386-408`
        on the card's terms)."""
        verdict = cand.get("lowerable") or {}
        if not verdict.get("lowerable"):
            return False, verdict.get("reason", "not lowerable")
        try:
            from ..nodes.util.fusion import _peephole, stage_fuse
            from ..ops.chain_kernels import chain_layout
            from ..workflow.fusion_rule import FusedChainOperator
            from .specs import trace_element

            op = self.graph.get_operator(vid)
            stage_list = (list(op.stage_specs)
                          if isinstance(op, FusedChainOperator)
                          else list(op.stages))
            stages = _peephole(stage_list)
            i, j = cand["stage_slice"]
            elem = self.specs.get(self._data_dep(vid)).element
            for s in stages[:i]:
                elem = trace_element(
                    lambda x, s=s: s.single_transform([x]), (elem,))
            if verdict.get("family") != "elementwise_chain":
                return True, verdict.get("family", "")
            fused = [stage_fuse(s) for s in stages[i:j]]
            chain_layout([f[0] for f in fused], [f[1] for f in fused],
                         tuple(elem.shape), "cpu")
            return True, "row fits shared memory"
        except Exception as e:
            return False, f"feasibility probe failed: {e}"

    # ------------------------------------------------------------ scorer

    def score(self, a: Assignment) -> float:
        """Predicted seconds of one complete assignment; INF where it
        busts ``hbm_budget_bytes``."""
        families = a.fam()
        policies = a.pol()
        trails = a.trl()
        kernels = a.krn()
        chunk = max(1, a.chunk)
        runs = self._runs.get(a.caches)
        if runs is None:
            runs = self._runs[a.caches] = self._get_runs(self.graph,
                                                         set(a.caches))
        total = 0.0
        bw = self.machine.peak_bw

        # pinned caches must fit the budget; a spilled one pins two
        # windows of its rows
        if self.budget:
            pinned = 0
            for vid in a.caches:
                shards = family_shards(families.get(vid), self.layout)
                nb = (self.vbytes(vid, policies.get(vid, POLICY_F32))
                      or 0)
                if vid in a.spills:
                    count = max(1, self._count(vid))
                    nb = int(2 * (nb / count) * chunk)
                pinned += nb // max(1, shards)
            if pinned > self.budget:
                return _INF

        # a spilled cache: one eviction, then a windowed reload per
        # consuming run, over the host link, a dispatch a window trip
        if a.spills:
            host_bw = self.host_bandwidth()
            for vid in a.spills:
                if vid not in a.caches:
                    continue
                nb = (self.vbytes(vid, policies.get(vid, POLICY_F32))
                      or 0)
                count = max(1, self._count(vid))
                trips = max(1, math.ceil(count / chunk))
                reruns = max(1, runs.get(vid, 1))
                total += nb / host_bw
                total += reruns * (nb / host_bw
                                   + trips * DISPATCH_OVERHEAD_S)

        for vid, st in self.roof.stages.items():
            pol_v = policies.get(vid, POLICY_F32)
            dep = self._data_dep(vid)
            pol_u = policies.get(dep, POLICY_F32) if dep is not None \
                else POLICY_F32
            out_b = self.vbytes(vid, pol_v)
            in_b = self.vbytes(dep, pol_u) if dep is not None else None
            if out_b is not None and in_b is not None:
                nbytes = in_b + out_b
            elif out_b is not None:
                nbytes = 2 * out_b
            else:
                nbytes = st.hbm_bytes
            trail = self.program_trails.get(vid)
            if trail is not None and trails.get(vid):
                # the bf16 trail halves the program's internal
                # boundaries (a write and a read each) and pays its casts
                _, saved, _ = trail
                nbytes = max(0, nbytes - 2 * saved)
                casts = sum(1 for s in trail[0] if s is not None)
                total += casts * CAST_PENALTY_BYTES / bw
            kc = self.kernel_candidates.get(vid)
            if kc is not None and kernels.get(vid):
                # the chain kernel keeps the slice's boundaries on chip;
                # an infeasible one makes the assignment infeasible
                if not kc["feasible"][0]:
                    return _INF
                nbytes = max(0, nbytes - 2 * kc["boundary_bytes"])
            count = self._count(vid)
            trips = max(1, math.ceil(count / chunk))
            if self.budget and count:
                # a chunk's live rows must fit the budget too
                shards = family_shards(families.get(vid), self.layout)
                per_row = nbytes / count
                if per_row * chunk / max(1, shards) > self.budget:
                    return _INF
            sec = stage_cost(st.flops, nbytes, self.machine)
            sec += trips * DISPATCH_OVERHEAD_S
            total += sec * max(1, runs.get(vid, 1))

        # graph-level storage flips
        if self.prmodel is not None:
            for vid in self.order:
                if not isinstance(vid, NodeId):
                    continue
                sv = _STORAGE[policies.get(vid, POLICY_F32)]
                for d in self.graph.get_dependencies(vid):
                    if not isinstance(self.specs.get(d), DataSpec):
                        continue
                    if _STORAGE[policies.get(d, POLICY_F32)] != sv:
                        total += CAST_PENALTY_BYTES / bw
        if self.pmodel is not None:
            placed = self._placement_seconds(families, policies)
            if placed == _INF:
                return _INF
            total += placed
        return total

    def _placement_seconds(self, families, policies) -> float:
        """The placement's collective seconds (`:536-588`): the sharding
        planner's formulas at the bytes the chosen dtypes move, a
        dispatch a move besides; INF where a family busts the budget."""
        pm = self.pmodel
        total = 0.0
        for vid in pm.order:
            fam_v = families.get(vid)
            if fam_v is not None and vid in pm.menus:
                if pm.node_cost(vid, fam_v) == _INF:
                    return _INF
                spec = self.specs.get(vid)
                if fam_v == FAMILY_REPLICATED and spec.nbytes \
                        and spec.nbytes >= pm.threshold:
                    total += float(meshlib.collective_cost(
                        "broadcast", spec.nbytes, shards=self.layout.size,
                        mesh=self.layout).seconds)
            demands = pm.demands(vid, {})
            all_deps = (list(self.graph.get_dependencies(vid))
                        if isinstance(vid, NodeId) else [])
            for d in pm.data_deps(vid):
                fam_u = families.get(d)
                u_spec = self.specs.get(d)
                nbytes = self.vbytes(d, policies.get(d, POLICY_F32))
                if nbytes is None:
                    nbytes = pm.vbytes(u_spec)
                if pm.is_host(vid):
                    cost = gather_cost(fam_u, nbytes, self.layout)
                else:
                    i = all_deps.index(d) if d in all_deps else -1
                    demand = demands[i] if 0 <= i < len(demands) else None
                    if demand is not None:
                        cost = demand_cost(demand, fam_u, nbytes,
                                           self.layout)
                    elif fam_v is not None:
                        cost = transition_cost(fam_u, fam_v, nbytes,
                                               self.layout, u_spec=u_spec)
                    else:
                        cost = None
                if cost is not None:
                    total += float(cost.seconds) + DISPATCH_OVERHEAD_S
        return total

    # ----------------------------------------------------- the sequential

    def sequential(self) -> Assignment:
        """The sequential rules' plan as a point of the joint space: the
        sharding planner's families, the precision rule's trails (above
        its floor), `plan_precision`'s boundary policies, the config's
        chunk, no cache (`:585-606`)."""
        families = dict(self.splan.families) if self.splan else {}
        policies = dict(self.pplan.policies) if self.pplan else {}
        trails = {
            vid: bool(saved >= self.precision_floor_bytes)
            for vid, (_, saved, _) in self.program_trails.items()
        }
        return _assign(families, policies, trails, self.chunk_default,
                       frozenset())

    # ------------------------------------------------------------ solver

    def chain_dp(self, seed: Assignment) -> Assignment:
        """The chain DP over (family, policy) product states along each
        fan-out-free chain of choosable vertices, greedy at fan-in
        (`:611-731`)."""
        families = seed.fam()
        policies = seed.pol()
        fam_menu = dict(self.fam_menus)
        pol_menu = dict(self.prmodel.menus) if self.prmodel else {}
        choosable = set(fam_menu) | set(pol_menu)
        if not choosable:
            return seed
        users = {vid: [u for u in self.graph.users_of(vid)
                       if not isinstance(u, SinkId)]
                 for vid in self.order}

        def states(vid) -> List[Tuple[Optional[str], str]]:
            fams = list(fam_menu.get(vid, (families.get(vid),)))
            pols = list(pol_menu.get(vid, (policies.get(vid, POLICY_F32),)))
            return [(f, p) for f in fams for p in pols]

        def edge_cost(u, us, v, vs) -> float:
            fam_u, pol_u = us
            fam_v, pol_v = vs
            sec = 0.0
            cost = transition_cost(fam_u, fam_v, self.vbytes(u, pol_u),
                                   self.layout, u_spec=self.specs.get(u))
            if cost is not None:
                sec += float(cost.seconds) + DISPATCH_OVERHEAD_S
            if _STORAGE[pol_u] != _STORAGE[pol_v]:
                sec += CAST_PENALTY_BYTES / self.machine.peak_bw
            return sec

        def node_cost(v, vs) -> float:
            fam_v, pol_v = vs
            if self.pmodel is not None and v in fam_menu \
                    and fam_v is not None \
                    and self.pmodel.node_cost(v, fam_v) == _INF:
                return _INF
            st = self.roof.stages.get(v)
            if st is None:
                return 0.0
            out_b = self.vbytes(v, pol_v)
            nbytes = 2 * out_b if out_b is not None else st.hbm_bytes
            return stage_cost(st.flops, nbytes, self.machine)

        visited: set = set()
        for vid in self.order:
            if vid not in choosable or vid in visited:
                continue
            head = vid
            while isinstance(head, NodeId):
                deps = [d for d in self.graph.get_dependencies(head)
                        if d in choosable]
                if len(deps) == 1 and len(users.get(deps[0], ())) == 1 \
                        and deps[0] not in visited:
                    head = deps[0]
                else:
                    break
            chain = [head]
            cur = head
            while True:
                kids = [u for u in users.get(cur, ())
                        if isinstance(u, NodeId) and u in choosable]
                if len(users.get(cur, ())) == 1 and len(kids) == 1 \
                        and kids[0] not in visited:
                    chain.append(kids[0])
                    cur = kids[0]
                else:
                    break
            visited.update(chain)
            table: Dict[Tuple, float] = {s: node_cost(chain[0], s)
                                         for s in states(chain[0])}
            back: List[Dict[Tuple, Tuple]] = []
            for prev, v in zip(chain, chain[1:]):
                nxt: Dict[Tuple, float] = {}
                bp: Dict[Tuple, Tuple] = {}
                for s in states(v):
                    best, best_c = None, _INF
                    for ps, pc in table.items():
                        c = pc + edge_cost(prev, ps, v, s)
                        if c < best_c:
                            best, best_c = ps, c
                    nxt[s] = best_c + node_cost(v, s)
                    bp[s] = best
                back.append(bp)
                table = nxt
            tail_state = min(table, key=lambda s: (table[s], str(s)))
            if table[tail_state] == _INF:
                continue
            assign = [tail_state]
            for bp in reversed(back):
                assign.append(bp[assign[-1]])
            assign.reverse()
            for v, (f, p) in zip(chain, assign):
                if v in fam_menu and f is not None:
                    families[v] = f
                if v in pol_menu:
                    policies[v] = p
        return replace(seed, families=_by_id(families),
                       policies=_by_id(policies))

    def descend(self, seed: Assignment, obj: float,
                ladder: Tuple[int, ...],
                sweeps: int = 2) -> Tuple[Assignment, float,
                                          List[Dict[str, Any]]]:
        """Bounded local descent across decision kinds (`:733-905`): the
        chunk ladder, trail and kernel toggles, greedy cache additions,
        spill toggles, policy sweeps, each trial scored by `score` and
        strict improvements kept. Returns the best assignment, its
        seconds and the priced entries scored (the ledger's menu)."""
        scored: List[Dict[str, Any]] = []
        seen_entries: set = set()
        best, best_obj = seed, obj

        def note(label: str, c: float) -> None:
            # one entry a label: later rounds score the same toggle
            # against other assignments
            if label not in seen_entries:
                seen_entries.add(label)
                scored.append({"entry": label, "predicted_seconds":
                               (None if c == _INF else float(c)),
                               "feasible": c != _INF})

        def try_(label: str, cand: Assignment) -> None:
            nonlocal best, best_obj
            c = self.score(cand)
            note(label, c)
            if c < best_obj:
                best, best_obj = cand, c

        for chunk in ladder:
            if chunk != best.chunk:
                try_(f"chunk_{chunk}", replace(best, chunk=chunk))
        for vid in self.program_trails:
            trails = best.trl()
            trails[vid] = not trails.get(vid, False)
            try_(f"trail_{getattr(vid, 'id', vid)}_"
                 f"{'on' if trails[vid] else 'off'}",
                 replace(best, trails=_by_id(trails)))
        for vid in self.kernel_candidates:
            kernels = best.krn()
            kernels[vid] = not kernels.get(vid, False)
            try_(f"kernel_{getattr(vid, 'id', vid)}_"
                 f"{'on' if kernels[vid] else 'off'}",
                 replace(best, kernels=_by_id(kernels)))
        # greedy cache additions: the best strict improvement, until none
        while True:
            gain_best, gain_cand = 0.0, None
            for vid in self.cache_candidates:
                if vid in best.caches:
                    continue
                cand = replace(best, caches=best.caches | {vid})
                c = self.score(cand)
                note(f"cache_{getattr(vid, 'id', vid)}", c)
                if best_obj - c > gain_best:
                    gain_best, gain_cand = best_obj - c, cand
            if gain_cand is None:
                break
            best, best_obj = gain_cand, best_obj - gain_best
        # spill toggles: a cache moved between the card and host memory,
        # each priced at its best chunk (a spill pins two windows)
        if self.allow_spill:
            for vid in self.cache_candidates:
                caches = set(best.caches)
                spills = set(best.spills)
                if vid in spills:
                    spills.discard(vid)
                else:
                    caches.add(vid)
                    spills.add(vid)
                flipped = replace(best, caches=frozenset(caches),
                                  spills=frozenset(spills))
                cands = [flipped] + [replace(flipped, chunk=c)
                                     for c in ladder
                                     if c != flipped.chunk]
                try_(f"spill_{getattr(vid, 'id', vid)}",
                     min(cands, key=self.score))
            if best.spills:
                for chunk in ladder:
                    if chunk != best.chunk:
                        try_(f"chunk_{chunk}", replace(best, chunk=chunk))
        fam_menu = dict(self.fam_menus)
        pol_menu = dict(self.prmodel.menus) if self.prmodel else {}
        for _sweep in range(sweeps):
            changed = False
            for vid in self.order:
                for fam in fam_menu.get(vid, ()):
                    if fam == best.fam().get(vid):
                        continue
                    fams = best.fam()
                    fams[vid] = fam
                    cand = replace(best, families=_by_id(fams))
                    c = self.score(cand)
                    if c < best_obj:
                        best, best_obj, changed = cand, c, True
                for pol in pol_menu.get(vid, ()):
                    if pol == best.pol().get(vid, POLICY_F32):
                        continue
                    pols = best.pol()
                    pols[vid] = pol
                    cand = replace(best, policies=_by_id(pols))
                    c = self.score(cand)
                    if c < best_obj:
                        best, best_obj, changed = cand, c, True
            if not changed:
                break
        return best, best_obj, scored


# --------------------------------------------------------------- the plan


@dataclass
class UnifiedPlan:
    """The joint decision, the sequential composition it was scored
    against by the same function, and the priced menu (`:910-1003`).
    Without ``improved`` the chosen assignment is the sequential one."""

    layout: Any
    chosen: Assignment
    sequential_assignment: Assignment
    joint_seconds: float
    sequential_seconds: float
    #: the menu entries the solver scored: the ledger's alternatives
    scored_candidates: List[Dict[str, Any]] = field(default_factory=list)
    #: vid -> (storage, saved_bytes, menu) of each trail the plan turns on
    program_precision: Dict[Any, Tuple] = field(default_factory=dict)
    #: the joint graph-level policies as a `PrecisionPlan` (the KP70x
    #: lint surface), None where the dtype axis had nothing to decide
    boundary_precision: Optional[Any] = None
    #: vid -> the KP801 candidate of each program run as a chain kernel
    kernel_choices: Dict[Any, Dict[str, Any]] = field(default_factory=dict)
    #: vid -> {bytes, window_trips, reload_seconds} of each spilled cache
    spill_predictions: Dict[Any, Dict[str, Any]] = field(
        default_factory=dict)
    unpriced_stages: int = 0
    #: the placement as a `ShardingPlan` over the joint families (what
    #: `ShardingPlannerRule._enforce` applies), None on one card
    sharding: Optional[ShardingPlan] = None

    @property
    def improved(self) -> bool:
        return self.joint_seconds < self.sequential_seconds

    @property
    def savings_seconds(self) -> float:
        return max(0.0, self.sequential_seconds - self.joint_seconds)

    @property
    def chunk_size(self) -> int:
        return self.chosen.chunk

    @property
    def default_chunk_size(self) -> int:
        return self.sequential_assignment.chunk

    @property
    def cache_vertices(self) -> List:
        return sorted(self.chosen.caches,
                      key=lambda v: getattr(v, "id", -1))

    @property
    def spill_vertices(self) -> List:
        """The cache points placed in host memory."""
        return sorted(self.chosen.spills,
                      key=lambda v: getattr(v, "id", -1))

    def changed_kinds(self) -> List[str]:
        """The decision kinds in which the joint plan deviates from the
        sequential one: what `UnifiedPlannerRule` enforces."""
        seq = self.sequential_assignment
        out = []
        if self.chosen.families != seq.families:
            out.append("placement")
        if self.chosen.trails != seq.trails \
                or self.chosen.policies != seq.policies:
            out.append("precision")
        if self.chosen.chunk != seq.chunk:
            out.append("chunk")
        if self.chosen.caches != seq.caches:
            out.append("cache")
        if self.chosen.kernels != seq.kernels:
            out.append("kernel")
        if self.chosen.spills != seq.spills:
            out.append("spill")
        return out

    def rows(self, graph: Graph) -> List[Dict[str, Any]]:
        """The chosen-against-sequential table in topological order."""
        order, _ = toposort(graph)
        seq = self.sequential_assignment
        fams, seq_fams = self.chosen.fam(), seq.fam()
        pols, seq_pols = self.chosen.pol(), seq.pol()
        trails, seq_trails = self.chosen.trl(), seq.trl()
        caches = set(self.chosen.caches)
        spills = set(self.chosen.spills)
        kernels = self.chosen.krn()
        rows = []
        for vid in order:
            if not isinstance(vid, NodeId):
                continue
            if vid not in fams and vid not in pols and vid not in trails \
                    and vid not in caches and vid not in kernels:
                continue
            rows.append({
                "vertex": vid.id,
                "label": _label(graph, vid),
                "family": fams.get(vid),
                "sequential_family": seq_fams.get(vid),
                "policy": pols.get(vid, POLICY_F32),
                "sequential_policy": seq_pols.get(vid, POLICY_F32),
                "trail": trails.get(vid),
                "sequential_trail": seq_trails.get(vid),
                "cached": vid in caches,
                "spilled": vid in spills,
                "kernel": bool(kernels.get(vid)),
                "changed": (fams.get(vid) != seq_fams.get(vid)
                            or pols.get(vid) != seq_pols.get(vid)
                            or trails.get(vid) != seq_trails.get(vid)
                            or vid in caches
                            or bool(kernels.get(vid))),
            })
        return rows


def format_plan(plan: UnifiedPlan, graph: Graph) -> str:
    lines = [
        f"joint ≈{plan.joint_seconds:.3e}s vs sequential "
        f"≈{plan.sequential_seconds:.3e}s "
        f"({'strict win' if plan.improved else 'no win: sequential plan'}"
        f", chunk {plan.default_chunk_size} → {plan.chunk_size}, "
        f"{len(plan.cache_vertices)} cache point(s), "
        f"{len(plan.spill_vertices)} spilled to host)"
    ]
    body = [f"{'stage':<36} {'policy':<14} {'cache':>5} {'kern':>5}"]
    for r in plan.rows(graph):
        mark = "*" if r["changed"] else " "
        pol = (f"{r['sequential_policy']}"
               + (f"→{r['policy']}" if r["policy"]
                  != r["sequential_policy"] else ""))
        cache = ("host" if r["spilled"] else "yes") if r["cached"] else ""
        body.append(
            f"{mark}{(r['label'] + '@' + str(r['vertex']))[:35]:<35} "
            f"{pol[:14]:<14} {cache:>5} "
            f"{'yes' if r['kernel'] else '':>5}")
    if len(body) > 1:
        lines.extend(body)
    return "\n".join(lines)


# ------------------------------------------------------------ entry point


def plan_unified(
    graph: Graph,
    specs: Dict[GraphId, Any],
    *,
    mesh=None,
    hbm_budget_bytes: Optional[int] = None,
    chunk_default: Optional[int] = None,
    machine: Optional[Machine] = None,
    weights=None,
    include_boundary_policies: bool = True,
    precision_floor_bytes: int = 0,
    ladder: Tuple[int, ...] = CHUNK_LADDER,
    allow_spill: Optional[bool] = None,
) -> Optional[UnifiedPlan]:
    """Solve the joint decision for one graph (`:1008-1181`).

    ``mesh`` is the device layout (`parallel/mesh.py::layout_of`: a
    live mesh, ``{"data": d, "model": m}``, or None for the current
    one); on more than one card the placement axis joins the menu.
    ``weights`` (a `cost_model.CostWeights`) or ``machine`` pins the
    rates; neither takes `calibrate.machine_rates()`. None where there
    is nothing to decide; ``improved`` is a strict win over the
    sequential composition, else the plan is the sequential one."""
    mesh = meshlib.layout_of(mesh)
    if weights is not None and machine is None:
        machine = machine_from_weights(weights)
    machine = machine or default_machine()
    from ..workflow.env import execution_config

    cfg = execution_config()
    chunk_default = int(chunk_default or cfg.chunk_size)
    if allow_spill is None:
        allow_spill = bool(cfg.ooc_spill)
    model = _UnifiedModel(
        graph, specs, mesh, hbm_budget_bytes, chunk_default, machine,
        include_boundary_policies=include_boundary_policies,
        precision_floor_bytes=precision_floor_bytes,
        allow_spill=allow_spill)
    if not model.roof.stages:
        return None
    has_axis = bool(model.cache_candidates or model.program_trails
                    or model.kernel_candidates or model.fam_menus
                    or (model.prmodel and model.prmodel.menus)
                    or any(model._count(v) > min(ladder)
                           for v in model.roof.stages))
    if not has_axis:
        return None

    # no chunk beyond the largest count's padded shape
    max_count = max((model._count(v) for v in model.roof.stages),
                    default=chunk_default)
    ladder = tuple(sorted({c for c in ladder
                           if c <= max(max_count, chunk_default)}
                          | {chunk_default}))

    seq = model.sequential()
    seq_obj = model.score(seq)
    scored: List[Dict[str, Any]] = [
        {"entry": "sequential", "predicted_seconds": float(seq_obj),
         "feasible": seq_obj != _INF},
    ]
    dp_seed = model.chain_dp(seq)
    dp_obj = model.score(dp_seed)
    scored.append({"entry": "chain_dp_product",
                   "predicted_seconds":
                   (None if dp_obj == _INF else float(dp_obj)),
                   "feasible": dp_obj != _INF})
    best, best_obj = (dp_seed, dp_obj) if dp_obj < seq_obj \
        else (seq, seq_obj)
    best, best_obj, descent_scored = model.descend(best, best_obj, ladder)
    scored.extend(descent_scored)
    scored.append({"entry": "joint_optimum",
                   "predicted_seconds":
                   (None if best_obj == _INF else float(best_obj)),
                   "feasible": best_obj != _INF})
    if not best_obj < seq_obj:
        best, best_obj = seq, seq_obj

    # the placement's enforcement payload: a ShardingPlan over the
    # joint families (`:1103-1123`)
    sharding = None
    if model.splan is not None and model.pmodel is not None:
        fams = best.fam()
        choices = {vid: model.pmodel.menus[vid][fam]
                   for vid, fam in fams.items()
                   if vid in model.pmodel.menus
                   and fam in model.pmodel.menus[vid]}
        _, planned_bytes, planned_boundary = model.pmodel.score(fams)
        sharding = ShardingPlan(
            mesh=mesh, families=fams,
            default_families=model.splan.default_families,
            choices=choices,
            default_shardings=model.splan.default_shardings,
            planned_cost_bytes=planned_bytes,
            default_cost_bytes=model.splan.default_cost_bytes,
            planned_boundary=planned_boundary,
            default_boundary=model.splan.default_boundary,
            scored_candidates=model.splan.scored_candidates)
    program_precision = {
        vid: model.program_trails[vid]
        for vid, on in best.trl().items()
        if on and vid in model.program_trails
    }
    kernel_choices = {
        vid: model.kernel_candidates[vid]
        for vid, on in best.krn().items()
        if on and vid in model.kernel_candidates
    }
    spill_predictions: Dict[Any, Dict[str, Any]] = {}
    if best.spills:
        host_bw = model.host_bandwidth()
        pols = best.pol()
        for vid in best.spills:
            nb = model.vbytes(vid, pols.get(vid, POLICY_F32)) or 0
            count = max(1, model._count(vid))
            trips = max(1, math.ceil(count / max(1, best.chunk)))
            spill_predictions[vid] = {
                "bytes": int(nb),
                "window_trips": int(trips),
                "reload_seconds": float(
                    2 * nb / host_bw + trips * DISPATCH_OVERHEAD_S),
            }
    boundary_precision = None
    if model.pplan is not None and model.prmodel is not None:
        policies = dict(model.pplan.default_policies)
        policies.update(best.pol())
        cost, boundary = model.prmodel.score(policies)
        boundary_precision = PrecisionPlan(
            policies=policies,
            default_policies=model.pplan.default_policies,
            planned_cost_bytes=cost,
            default_cost_bytes=model.pplan.default_cost_bytes,
            planned_boundary=boundary,
            default_boundary=model.pplan.default_boundary,
            tolerances=model.pplan.tolerances,
        )
    return UnifiedPlan(
        layout=mesh,
        chosen=best,
        sequential_assignment=seq,
        joint_seconds=float(best_obj),
        sequential_seconds=float(seq_obj),
        scored_candidates=scored,
        program_precision=program_precision,
        boundary_precision=boundary_precision,
        kernel_choices=kernel_choices,
        spill_predictions=spill_predictions,
        unpriced_stages=model.unpriced_stages,
        sharding=sharding,
    )
