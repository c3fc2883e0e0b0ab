"""The placement axis of the plan tier, on one card.

Counterpart of `keystone_tpu/analysis/planner.py:78-91, 160-290,
484-583`: the placement families a stage's output may take, how many
shards each splits it into, and the collective each family flip costs.
The unified planner (`plan_ir.py`) reads them. On one card every family
is the whole card: each family has one shard, every boundary collective
moves nothing (`parallel/mesh.py::collective_cost`, the one formula,
as JAX's, prices ``shards <= 1`` at zero, host gathers included) and
`plan_sharding` has nothing to decide, as JAX's returns None on a
one-device mesh. The multi-card menu (the data and model axes, the
KP6xx formulas over NVLink) extends this module with the sharding
planner (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..parallel.mesh import CollectiveCost, collective_cost  # noqa: F401
from ..workflow.graph import Graph, GraphId, NodeId
from .diagnostics import Diagnostic, Severity
from .memory import MemoryEstimate, _fmt_bytes
from .propagate import _label

#: the placement menu (`:78-84`)
FAMILY_DATA = "data"
FAMILY_DATA_MODEL = "data_model"
FAMILY_MODEL = "model"
FAMILY_REPLICATED = "replicated"
MENU: Tuple[str, ...] = (
    FAMILY_DATA, FAMILY_DATA_MODEL, FAMILY_MODEL, FAMILY_REPLICATED)

#: objective bytes charged per boundary move besides its payload (`:88`)
RESHARD_PENALTY_BYTES = 64 << 10

#: one card: the data and model axes of the device layout
ONE_CARD = {"data": 1, "model": 1}


def device_count(layout: Optional[Dict[str, int]] = None) -> int:
    layout = layout or ONE_CARD
    return int(layout.get("data", 1)) * int(layout.get("model", 1))


def family_shards(family: Optional[str],
                  layout: Optional[Dict[str, int]] = None) -> int:
    """Shards ``family`` splits a value into over ``layout``'s axes
    (`:160-170`): 1 for every family on one card."""
    layout = layout or ONE_CARD
    data = int(layout.get("data", 1))
    model = int(layout.get("model", 1))
    return {
        FAMILY_DATA: data,
        FAMILY_MODEL: model,
        FAMILY_DATA_MODEL: data * model,
        FAMILY_REPLICATED: 1,
        None: 1,
    }[family]


def transition_cost(u_fam: Optional[str], v_fam: Optional[str],
                    nbytes: Optional[int],
                    layout: Optional[Dict[str, int]] = None,
                    u_spec=None) -> Optional[CollectiveCost]:
    """The collective relaying a producer's output from its family to
    its consumer's (`:204-236`), or None where the boundary is free: a
    matching layout, a replicated producer, and every boundary of one
    card."""
    if u_fam is None or v_fam is None or not nbytes or u_fam == v_fam:
        return None
    if u_fam == FAMILY_REPLICATED:
        return None
    shards = max(family_shards(u_fam, layout), family_shards(v_fam, layout))
    if shards <= 1:
        return None
    kind = "all_gather" if v_fam == FAMILY_REPLICATED else "all_to_all"
    return collective_cost(kind, nbytes, shards)


def demand_cost(demand: Optional[str], fam: Optional[str],
                nbytes: Optional[int],
                layout: Optional[Dict[str, int]] = None
                ) -> Optional[CollectiveCost]:
    """An operator's unmet input-layout demand (`:251-276`): free on one
    card, where every family already holds the whole value."""
    if demand is None or fam is None or not nbytes:
        return None
    if device_count(layout) <= 1:
        return None
    return collective_cost("all_gather", nbytes, device_count(layout))


def gather_cost(fam: Optional[str], nbytes: Optional[int],
                layout: Optional[Dict[str, int]] = None
                ) -> Optional[CollectiveCost]:
    """A host consumer gathering a device-sharded value (`:292-299`):
    JAX prices it over the family's shards, which is zero on one card."""
    if fam is None or fam == FAMILY_REPLICATED or not nbytes:
        return None
    return collective_cost("all_gather", nbytes, family_shards(fam, layout))


def per_device_pass(graph: Graph, memory: MemoryEstimate,
                    hbm_budget_bytes: Optional[int] = None,
                    layout: Optional[Dict[str, int]] = None
                    ) -> List[Diagnostic]:
    """KP600 on one card (JAX `analysis/sharding.py:690-750`): the peak
    live memory of the card against ``hbm_budget_bytes``. Each value's
    share on one card is the whole value, so the card's residency is the
    memory model's live set (streaming and host-tier discounts
    included) and its peak the memory model's peak; the finding takes
    KP202's place at the full tier, as in JAX."""
    if device_count(layout) > 1:
        raise NotImplementedError(
            "per-card residency across cards comes with multi-GPU")
    peak, peak_at = memory.peak_bytes, memory.peak_at
    if not hbm_budget_bytes or peak <= hbm_budget_bytes:
        return []
    label = _label(graph, peak_at) if peak_at is not None else ""
    return [Diagnostic(
        "KP600", Severity.WARNING,
        f"peak PER-DEVICE live memory {_fmt_bytes(peak)} exceeds the "
        f"{_fmt_bytes(hbm_budget_bytes)} per-device HBM budget (peak at "
        f"{label}@{peak_at}, 1 device)",
        vertex=peak_at, label=label)]


@dataclass
class ShardingPlan:
    """A placement decision (`:484-520`): chosen families against the
    default, both priced. Built only where there is more than one card
    to place on."""

    families: Dict[GraphId, str]
    default_families: Dict[GraphId, str]
    planned_cost_bytes: float
    default_cost_bytes: float
    scored_candidates: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def improved(self) -> bool:
        return self.planned_cost_bytes < self.default_cost_bytes

    @property
    def savings_bytes(self) -> int:
        return max(0, int(self.default_cost_bytes - self.planned_cost_bytes))

    def changed_vertices(self) -> List[NodeId]:
        return [vid for vid, fam in sorted(
                    self.families.items(),
                    key=lambda kv: getattr(kv[0], "id", -1))
                if self.default_families.get(vid) != fam]

    def rows(self, graph: Graph) -> List[Dict[str, Any]]:
        """Chosen against default placement per stage in topological
        order (`:546-564`, the ``--explain-sharding --plan`` rows), the
        families in place of JAX's partition specs."""
        from .propagate import toposort

        order, _ = toposort(graph)
        changed = set(self.changed_vertices())
        return [{
            "vertex": vid.id,
            "label": _label(graph, vid),
            "default_spec": str(self.default_families.get(vid) or "—"),
            "chosen_spec": str(self.families.get(
                vid, self.default_families.get(vid)) or "—"),
            "changed": vid in changed,
            "default_boundary_bytes": 0,
            "planned_boundary_bytes": 0,
        } for vid in order if isinstance(vid, NodeId)]


def format_plan(rows: List[Dict[str, Any]]) -> str:
    """Text table of `ShardingPlan.rows` (`:567-578`)."""
    lines = [f"{'stage':<38} {'default':<20} {'chosen':<20} {'Δbytes':>12}"]
    for r in rows:
        delta = r["default_boundary_bytes"] - r["planned_boundary_bytes"]
        mark = "*" if r["changed"] else " "
        name = f"{r['label']}@{r['vertex']}"
        col = f"{delta:+,d}" if delta else "—"
        lines.append(
            f"{name[:38]:<38} {r['default_spec'][:20]:<20} "
            f"{mark}{r['chosen_spec'][:19]:<19} {col:>12}")
    return "\n".join(lines)


def plan_sharding(graph: Graph, specs: Dict[GraphId, Any], *,
                  layout: Optional[Dict[str, int]] = None,
                  hbm_budget_bytes: Optional[int] = None
                  ) -> Optional[ShardingPlan]:
    """The placement plan (`:547-583`): None where there is nothing to
    decide, which on one card is always."""
    if device_count(layout) <= 1:
        return None
    raise NotImplementedError(
        "placement across cards comes with the sharding planner (ROADMAP "
        "queue 1, item 4)")
