"""Multi-tenant registry: KP905's priced residency as the admission gate.

Counterpart of `keystone_tpu/serving/registry.py`. Several warmed fitted
pipelines can share one card, but their residency is priced, not
discovered: each tenant's certificate carries its statically priced
``per_device_peak_bytes``, and the registry refuses admission
(`AdmissionRefused`) when the resident peaks plus the candidate's would
exceed the device memory budget (``KEYSTONE_HBM_BUDGET_GB``, or the one
given). Every decision lands in the ledger as a ``serving_admission``
record; ``serving.tenants`` and ``serving.resident_bytes`` are gauges.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..telemetry.ledger import record_decision
from ..telemetry.metrics import gauge
from ..workflow.env import execution_config


class AdmissionRefused(RuntimeError):
    """Registering this tenant would exceed the priced device memory
    budget: refused before any device allocation happens."""


class TenantRegistry:
    """Admission-controlled map of tenant name → serving runtime."""

    def __init__(self, hbm_budget_bytes: Optional[int] = None):
        if hbm_budget_bytes is None:
            hbm_budget_bytes = execution_config().hbm_budget_bytes
        self.hbm_budget_bytes = (int(hbm_budget_bytes)
                                 if hbm_budget_bytes else None)
        self._tenants: Dict[str, Any] = {}
        self._peaks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._resident = gauge("serving.tenants")
        self._resident_bytes = gauge("serving.resident_bytes")

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._peaks.values())

    def _record(self, name: str, peak: int, total_after: int,
                admitted: bool) -> None:
        budget = self.hbm_budget_bytes
        try:
            record_decision(
                kind="serving_admission",
                rule="KP905",
                vertices=[],
                labels=[name],
                chosen={"entry": "admit" if admitted else "refuse"},
                alternatives=[
                    {"entry": "admit", "cost_seconds": 0.0},
                    {"entry": "refuse", "cost_seconds": 0.0},
                ],
                predicted={
                    "tenant_peak_bytes": float(peak),
                    "resident_bytes_after": float(total_after),
                    "hbm_budget_bytes": float(budget or 0),
                },
                enforced=True,
            )
        except Exception:
            pass

    def admit(self, name: str, runtime: Any, *,
              per_device_peak_bytes: Optional[int] = None) -> Any:
        """Register ``runtime`` under ``name`` iff its priced residency
        fits the budget alongside every already-resident tenant. The
        peak defaults to the runtime certificate's KP905 price."""
        if per_device_peak_bytes is None:
            cert = getattr(runtime, "certificate", None)
            per_device_peak_bytes = int(
                getattr(cert, "per_device_peak_bytes", 0) or 0)
        peak = max(0, int(per_device_peak_bytes))
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} is already resident")
            total_after = sum(self._peaks.values()) + peak
            budget = self.hbm_budget_bytes
            if budget is not None and total_after > budget:
                self._record(name, peak, total_after, admitted=False)
                raise AdmissionRefused(
                    f"tenant {name!r} priced at {peak} B would bring "
                    f"residency to {total_after} B > budget {budget} B "
                    "(KP905) — admission refused statically")
            self._tenants[name] = runtime
            self._peaks[name] = peak
            self._resident.set(len(self._tenants))
            self._resident_bytes.set(total_after)
        self._record(name, peak, total_after, admitted=True)
        return runtime

    def evict(self, name: str) -> Optional[Any]:
        with self._lock:
            runtime = self._tenants.pop(name, None)
            self._peaks.pop(name, None)
            self._resident.set(len(self._tenants))
            self._resident_bytes.set(sum(self._peaks.values()))
        return runtime

    def get(self, name: str) -> Any:
        with self._lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(f"tenant {name!r} is not resident")

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)
