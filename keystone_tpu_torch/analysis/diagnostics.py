"""Diagnostics of the structural pipeline check.

Counterpart of `keystone_tpu/analysis/diagnostics.py` (`Severity`,
`RULES`, `Diagnostic`, `ValidationReport`, `PipelineValidationError`,
`:17-283`): every finding is a
`Diagnostic` with a stable rule id, a severity and the graph vertex it
anchors to. Only the structural tier's rules (KP001–KP005) exist here;
the JAX package's spec, memory, sharding and roofline tiers are not
ported.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence


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
    """The check's result: its diagnostics."""

    def __init__(self, diagnostics: Sequence[Diagnostic],
                 level: str = "structure"):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        self.level = level

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
    """The structural check rejected the pipeline before any data ran.

    A ValueError, so callers that treat malformed graphs as value errors
    keep working."""

    def __init__(self, report: ValidationReport):
        super().__init__(str(report))
        self.report = report
