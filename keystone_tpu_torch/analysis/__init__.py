"""Static pipeline analyzer: check pipelines abstractly, before any data
loads.

Counterpart of `keystone_tpu/analysis/__init__.py:1-298`. The tiers the
port runs, cumulative by level: ``"structure"`` (topology lints, the
check `GraphExecutor` runs before the first force) ⊂ ``"specs"``
(shapes and dtypes propagated by running stage bodies on meta tensors)
⊂ ``"memory"`` (live-memory estimates) ⊂ ``"full"`` (donation and
streaming hazards, KP401, the operator contracts (KP501–KP504,
`contracts.py`), KP511 where the concurrent scheduler is on,
the sharding tier (`sharding.py`: partition specs propagated over the
mesh layout, KP601–KP605, and a card's residency against the budget,
KP600, in KP202's place), the roofline, the precision lints of a given
plan (KP701–KP703), and the serving certificate where an envelope is
declared).

Entry points: ``Pipeline.validate(source_spec, level=..., serving=...)``
and ``validate_graph(graph, source_specs, ...)``. The plan tier's
deciders are `precision.plan_precision` / `plan_stage_precision` and
`plan_ir.plan_unified` and `planner.plan_sharding`, which
`workflow/optimizer.py`'s planner rules enforce. `contracts.audit_registry`
audits every operator class of the port; `reconcile.py` joins a trace's
static estimates and a run's decisions against what the run observed;
``python -m keystone_tpu_torch.analysis`` is the CLI (`__main__.py`).
The JAX package's kernel proofs (KP10xx) are about Mosaic's VMEM and
have no counterpart.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from .diagnostics import (
    RULES,
    Diagnostic,
    PipelineValidationError,
    Severity,
    ValidationReport,
)
from .contracts import audit_operator, audit_registry, contract_pass
from .effects import class_effects, interference_pass, operator_effects
from .hazards import hazard_pass, megafusion_pass
from .memory import MemoryEstimate, memory_pass, resolve_chunk_rows
from .plan_ir import UnifiedPlan, plan_unified
from .planner import ShardingPlan, plan_sharding
from .sharding import (
    PartitionRule,
    ShardedValue,
    ShardingResult,
    fit_sharding_demands,
    per_device_pass,
    sharding_pass,
)
from .precision import (
    PrecisionPlan,
    plan_precision,
    plan_stage_precision,
    precision_pass,
    reprice_memory,
)
from .propagate import spec_pass, structural_pass, toposort
from .roofline import (
    Machine,
    RooflineEstimate,
    StageRoofline,
    default_machine,
    roofline_pass,
    stage_cost,
)
from .serving import (
    ServingCertificate,
    ServingEnvelope,
    certify_example,
    envelope_from_env,
    ladder_shapes,
    serving_pass,
    warmup_manifest,
)
from .specs import (
    UNKNOWN,
    DataSpec,
    ShapeDtype,
    SpecDataset,
    SpecMismatchError,
    TransformerSpec,
    as_source_spec,
    element_nbytes,
    shape_struct,
    spec_of,
)

LEVELS = ("structure", "specs", "memory", "full")


def validate_graph(
    graph,
    source_specs: Optional[Dict] = None,
    *,
    level: str = "full",
    ignore: Iterable[str] = (),
    hbm_budget_bytes: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    serving=None,
    precision=None,
    partition_rules: Iterable = (),
    mesh=None,
) -> ValidationReport:
    """Run the analyzer tiers up to ``level`` over a lowered graph
    (`keystone_tpu/analysis/__init__.py:105-224`).

    ``source_specs`` maps each unbound `SourceId` to its input spec
    (anything `as_source_spec` accepts); unlisted sources are UNKNOWN.
    ``serving`` (level "full") is a `ServingEnvelope` arming the KP9xx
    certifier; None falls back to ``KEYSTONE_SLO_MS``, and with neither
    the serving tier is skipped. ``precision`` (level "full") is a
    `PrecisionPlan` to lint (KP701, KP702) and re-price (KP703), as
    `plan_unified`'s ``boundary_precision``; JAX's package runs these
    lints from its CLI. ``partition_rules`` (level "full") are
    `PartitionRule`s or ``(regex, PartitionSpec)`` pairs pinning a
    stage's placement; ``mesh`` is the layout the sharding tier places
    on (a live mesh, ``{"data": d, "model": m}``, or None for the
    current one). Touches no data and no device."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    tier = LEVELS.index(level)

    diags = list(structural_pass(graph))
    specs: Dict = {}
    memory: Optional[MemoryEstimate] = None
    roofline = None

    if tier >= 1:
        normalized = {src: as_source_spec(s)
                      for src, s in (source_specs or {}).items()}
        specs, spec_diags = spec_pass(graph, normalized)
        # cycles are the structural pass's finding already
        diags.extend(d for d in spec_diags if d.rule != "KP001")
    if tier >= 2:
        memory, mem_diags = memory_pass(
            graph, specs, hbm_budget_bytes=hbm_budget_bytes,
            chunk_rows=chunk_rows)
        diags.extend(mem_diags)
    serving_cert = None
    shardings: Dict = {}
    if tier >= 3:
        from ..workflow.env import execution_config

        cfg = execution_config()
        diags.extend(hazard_pass(graph, specs, overlap=cfg.overlap))
        if cfg.megafusion:
            diags.extend(megafusion_pass(graph))
        # the contract tier (`:159-164`): KP5xx over this graph's
        # operators at their propagated specs
        diags.extend(contract_pass(graph, specs))
        if cfg.concurrent_dispatch:
            # KP511 matters only while the scheduler can force unordered
            # vertices at once
            diags.extend(interference_pass(graph))
        # the sharding tier (`:171-192`): specs propagated over the
        # layout, the boundary lints, and a card's peak against the
        # budget, KP600's finding in KP202's place
        shardings, shard_diags, _ = sharding_pass(
            graph, specs, mesh=mesh, rules=partition_rules)
        diags.extend(shard_diags)
        if memory is not None:
            budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                      else cfg.hbm_budget_bytes)
            _, pd_diags = per_device_pass(graph, specs, shardings, memory,
                                          mesh=mesh,
                                          hbm_budget_bytes=budget)
            diags = [d for d in diags if d.rule != "KP202"] + pd_diags
        if precision is not None:
            diags.extend(precision_pass(graph, specs, precision))
            _, _, kp703 = reprice_memory(graph, specs, precision,
                                         chunk_rows=chunk_rows)
            diags.extend(kp703)
        roofline, roof_diags = roofline_pass(graph, specs,
                                             chunk_rows=chunk_rows)
        diags.extend(roof_diags)
        envelope = serving if serving is not None else envelope_from_env()
        if envelope is not None:
            serving_cert, serve_diags = serving_pass(
                graph, specs, envelope, memory=memory, roofline=roofline,
                hbm_budget_bytes=hbm_budget_bytes, chunk_rows=chunk_rows)
            diags.extend(serve_diags)

    report = ValidationReport(diags, specs=specs, memory=memory,
                              level=level, roofline=roofline,
                              serving=serving_cert, shardings=shardings)
    return report.filter(ignore) if ignore else report


def structural_report(graph) -> ValidationReport:
    """The structure tier: the O(V+E) check `GraphExecutor` runs before
    the first force."""
    return ValidationReport(structural_pass(graph), level="structure")


__all__ = [
    "DataSpec", "Diagnostic", "LEVELS", "Machine", "MemoryEstimate",
    "PartitionRule", "PipelineValidationError", "PrecisionPlan", "RULES",
    "RooflineEstimate", "ShardedValue", "ShardingPlan", "ShardingResult",
    "ServingCertificate", "ServingEnvelope", "Severity", "ShapeDtype",
    "SpecDataset", "SpecMismatchError", "StageRoofline", "TransformerSpec",
    "UNKNOWN", "ValidationReport", "as_source_spec", "certify_example",
    "audit_operator", "audit_registry", "contract_pass",
    "class_effects", "default_machine", "element_nbytes",
    "envelope_from_env", "fit_sharding_demands", "hazard_pass",
    "interference_pass",
    "ladder_shapes", "megafusion_pass", "memory_pass", "operator_effects",
    "per_device_pass", "plan_precision", "plan_sharding",
    "plan_stage_precision", "plan_unified", "precision_pass",
    "reprice_memory", "resolve_chunk_rows", "roofline_pass",
    "serving_pass", "shape_struct", "sharding_pass",
    "spec_of", "spec_pass", "stage_cost", "structural_pass",
    "structural_report", "toposort", "UnifiedPlan", "validate_graph",
    "warmup_manifest",
]
