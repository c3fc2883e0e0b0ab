"""Diagnostics of the static pipeline analyzer.

Counterpart of `keystone_tpu/analysis/diagnostics.py` (`Severity`,
`RULES`, `Diagnostic`, `ValidationReport`, `PipelineValidationError`,
`:17-283`): every finding is a `Diagnostic` with a stable rule id, a
severity and the graph vertex it anchors to. The rules of the tiers the
port runs are here: structure (KP0xx), specs (KP1xx), memory (KP2xx),
hazards (KP3xx, KP401), operator contracts (KP501–KP504), effects
(KP511), sharding (KP600 a card's residency, KP601–KP605 the boundary
collectives and placements, `sharding.py`), precision (KP701–KP703),
roofline (KP8xx) and serving (KP9xx). The JAX package's kernel-proof
tier (KP10xx) is about Mosaic's VMEM and has no counterpart.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2


#: rule id -> one-line description (the JAX package's ANALYSIS.md holds
#: the full docs)
RULES = {
    "KP001": "cycle: the graph contains a dependency cycle",
    "KP002": "arity: an operator has the wrong number of dependencies",
    "KP003": "fit-before-use: an estimator's output is consumed as data",
    "KP004": "delegate-without-estimator: a DelegatingOperator's first "
             "dependency does not produce a transformer",
    "KP005": "dangling-source: a source has no consumers",
    # spec tier
    "KP101": "shape-mismatch: running a stage on meta tensors proved it "
             "cannot run on its input shapes/dtypes",
    "KP102": "count-mismatch: sibling datasets disagree on example count",
    # memory tier
    "KP201": "node-memory: one node's materialized output exceeds the "
             "device memory budget",
    "KP202": "peak-memory: peak live memory across the schedule exceeds "
             "the device memory budget",
    "KP203": "overlap-amplification: prefetch depth multiplies a streaming "
             "stage's resident footprint",
    "KP204": "megafused-loop-live-set: the captured chunk loop's per-trip "
             "carry rides on top of stacked-input + output residency",
    # sharding tier (`sharding.py`; KP600 takes KP202's place at full)
    "KP600": "per-device-hbm: peak live memory per device — live-set "
             "residency divided over each leaf's actual shard count — "
             "exceeds the per-device HBM budget",
    "KP601": "implicit-reshard: producer and consumer disagree on a stage "
             "boundary's partition spec; the run moves the boundary "
             "bytes there (an all-to-all)",
    "KP602": "large-operand-replicated: an array above the replication "
             "threshold is held replicated although a mesh axis could "
             "shard one of its dimensions evenly",
    "KP603": "gather-of-sharded-into-host: a host-code stage consumes "
             "device-sharded data, forcing an all-gather of every shard "
             "onto the host",
    "KP604": "mesh-indivisible-rows: the data-shard count does not divide "
             "the propagated example count, so padded shards change "
             "per-device shapes across stages",
    "KP605": "invalid-partition-rule: a PartitionRule (or a hook or plan "
             "placement) pins a spec that cannot apply to the matched "
             "stage — more entries than the value has dimensions, or a "
             "mesh axis the current mesh does not have",
    # precision tier
    "KP701": "precision-policy-on-intolerant-stage: a reduced-precision "
             "policy is pinned on a boundary whose producer or consumer "
             "declares (or probes) exact f32 precision",
    "KP702": "cast-thrash: a boundary stores bf16 but every consumer's "
             "boundary is f32 and the halving saves less than the two "
             "casts the flip pair costs",
    "KP703": "dtype-dependent memory re-pricing: a chosen precision "
             "policy changes a stage's static KP2xx residency (bf16 "
             "halves the chosen float boundaries) — informational",
    # hazard tier
    "KP301": "donation-reuse: a buffer an operator writes in place is "
             "still reachable by another consumer",
    "KP302": "stream-materialization: a streaming stage feeds a "
             "non-chunkable operator, silently materializing the stream",
    "KP303": "cache-on-stream: a cache node on a streaming stage "
             "materializes the stream and defeats overlap",
    "KP401": "megafusion-fallback: a stage keeps this plan from collapsing "
             "to one captured chunk loop (fan-out, host code, or a "
             "streaming origin); the per-stage dispatch path remains",
    # operator contract tier (`analysis/contracts.py`)
    "KP501": "fusable-without-structural-fuse: a fusable stage's fused "
             "program key is id-keyed (opaque), so fused programs "
             "containing it re-trace on every rebuilt pipeline",
    "KP502": "chunkable-non-distributive: a chunkable-declared batch path "
             "provably does not distribute over host chunks "
             "(f(concat(chunks)) != concat(f(chunks)) under eval_shape)",
    "KP503": "donation-not-implemented: donates_deps is declared but no "
             "reachable jitted step donates its arguments (or the "
             "donate_argnums are mis-indexed against the step signature)",
    "KP504": "unmasked-fused-stage: the unfused batch path masks padded "
             "rows but fuse_masks_output is undeclared — fused programs "
             "would corrupt padded rows",
    # concurrency effect tier
    "KP511": "concurrent-effect-interference: two effectful vertices with "
             "no dependency ordering share mutable state; the concurrent "
             "scheduler may force them simultaneously",
    # roofline tier
    "KP801": "kernel-candidate: a bandwidth-bound fan-out-free fused "
             "chain of >=2 stages whose internal boundaries round-trip "
             "device memory stage at a time, priced with the boundary "
             "bytes one kernel would keep on chip",
    "KP802": "data-movement-dominated stage: pure copy/view/index "
             "traffic at least the larger of the stage's compute and its "
             "unavoidable boundary bytes",
    "KP803": "plan-roofline: the whole plan re-priced in predicted "
             "seconds (max(flops/peak_flops, bytes/peak_bw) per stage) "
             "against the calibrated machine balance — informational",
    "KP804": "megafused-loop-underfilled: the captured chunk loop's "
             "per-trip compute is below the dispatch/loop overhead "
             "floor — raise chunk_size",
    "KP805": "chain-kernel-wins: a KP801 candidate lowers to the "
             "elementwise chain kernel (ops/chain_kernels) whose "
             "predicted seconds beat the stage-at-a-time chain",
    # serving tier
    "KP901": "serving-host-stage: an apply-path stage that cannot run on "
             "meta tensors (host code, or no propagated element spec) — "
             "it can neither be warmed nor captured, so the "
             "one-warm-program serving claim fails at this stage",
    "KP902": "serving-recompile-exposure: an apply-path device stage "
             "outside every warmable fused program runs cold at each "
             "pad-ladder shape the envelope can produce (INFO when the "
             "warmup manifest covers every shape)",
    "KP903": "serving-latency-bound: the certified per-shape latency "
             "upper bound (headroom x roofline seconds + per-program "
             "floors) vs the declared SLO; ERROR when the worst "
             "in-envelope shape busts it, with the dominating stage named",
    "KP904": "serving-donated-request: an apply-path operator writes "
             "into the pipeline's own input tensor in place — a serving "
             "caller retains the request it passed",
    "KP905": "serving-multi-tenant-residency: per-device peak bytes x "
             "declared concurrent warmed pipelines exceeds the device "
             "memory budget",
    "KP906": "serving-telemetry-cardinality: an apply-path operator "
             "formats a telemetry metric name dynamically in a hot "
             "method — per-request names grow the registry without bound",
}


@dataclass(frozen=True)
class Diagnostic:
    rule: str
    severity: Severity
    message: str
    vertex: Optional[Any] = None  # GraphId
    label: str = ""

    @property
    def anchor(self) -> str:
        """Stable diagnostic key: ``label@vertex``."""
        if self.vertex is None:
            return self.label or "<graph>"
        return f"{self.label}@{self.vertex}" if self.label else str(self.vertex)

    def __str__(self) -> str:
        return f"[{self.severity.name}] {self.rule} {self.anchor}: {self.message}"


class ValidationReport:
    """The analyzer's result: diagnostics plus, where the tiers ran, the
    per-vertex specs, the memory and roofline estimates and the serving
    certificate."""

    def __init__(self, diagnostics: Sequence[Diagnostic],
                 specs: Optional[dict] = None, memory: Optional[Any] = None,
                 level: str = "structure", roofline: Optional[Any] = None,
                 serving: Optional[Any] = None,
                 shardings: Optional[dict] = None):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        self.specs = specs or {}
        self.memory = memory
        self.level = level
        #: the propagated partition specs a vertex (`sharding.py`;
        #: level "full"), else empty
        self.shardings = shardings or {}
        #: the roofline estimate (level "full"), else None
        self.roofline = roofline
        #: the serving certificate (level "full" with an envelope
        #: declared), else None
        self.serving = serving

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def filter(self, ignore: Iterable[str]) -> "ValidationReport":
        """Drop diagnostics whose rule id is in ``ignore``."""
        ignore = set(ignore)
        return ValidationReport(
            [d for d in self.diagnostics if d.rule not in ignore],
            specs=self.specs, memory=self.memory, level=self.level,
            roofline=self.roofline, serving=self.serving,
            shardings=self.shardings)

    def raise_for_errors(self) -> "ValidationReport":
        if self.errors:
            raise PipelineValidationError(self)
        return self

    def __str__(self) -> str:
        head = (f"pipeline validation [{self.level}]: "
                f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)")
        if not self.diagnostics:
            return head
        return head + "\n" + "\n".join(f"  {d}" for d in self.diagnostics)

    def __repr__(self) -> str:
        return (f"ValidationReport(level={self.level!r}, "
                f"errors={len(self.errors)}, warnings={len(self.warnings)})")


class PipelineValidationError(ValueError):
    """Static validation rejected the pipeline before any data ran.

    A ValueError, so callers that treat malformed graphs as value errors
    keep working."""

    def __init__(self, report: ValidationReport):
        super().__init__(str(report))
        self.report = report
