"""Static checks of a pipeline's graph.

Counterpart of the structural tier of `keystone_tpu/analysis`
(`structural_report`, `analysis/__init__.py:225`). The spec, memory,
sharding and roofline tiers are not ported (ROADMAP queue 1).
"""

from .diagnostics import (
    RULES,
    Diagnostic,
    PipelineValidationError,
    Severity,
    ValidationReport,
)
from .propagate import structural_pass, toposort


def structural_report(graph) -> ValidationReport:
    """The structure tier: the O(V+E) check `GraphExecutor` runs before
    the first force."""
    return ValidationReport(structural_pass(graph), level="structure")


__all__ = [
    "Diagnostic", "PipelineValidationError", "RULES", "Severity",
    "ValidationReport", "structural_pass", "structural_report", "toposort",
]
