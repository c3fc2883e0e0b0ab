"""The persistent request loop behind the KP9xx certificate.

Counterpart of `keystone_tpu/serving/runtime.py`. `ServingRuntime`
serves traffic because it holds a certificate; `start()` is a strict
sequence, and nothing dispatches until each step holds:

  1. **Certify**: the KP9xx pass (`analysis.serving.serving_pass`) over
     the fitted apply graph at the declared element, propagated at the
     envelope's largest rung. An uncertified pipeline is refused
     (`CertificationError`; ``require_certified=False`` for experiments).
  2. **Arm**: the conformance watchdog from the certificate record, so
     every dispatched apply is checked against its rung's KP903 bound.
  3. **Warm**: the certificate's warmup manifest (every fused program
     site × every ladder rung) through `workflow.executor.
     warm_fitted_manifest`, waited for: on the card each rung's CUDA
     graph is captured (kernels built and launch plans made on the way),
     so after `start()` every dispatch is a replay and nothing is
     captured, built or planned.
  4. **Handoff**: one ``serving_handoff`` ledger record.
  5. **Serve**: the `MicroBatcher` dispatcher starts; `submit()` goes
     through the ingress, the batcher and `FittedPipeline.apply`.

Requests and answers are host numpy arrays: a dispatch copies its
stacked (padded) batch to the device once and the answers back once.

Hot swap (`swap`, `swap_from`): the new version is certified and warmed
on the calling thread while the dispatcher goes on replaying the old one
(`utils/graphs.py` captures on a side stream in ``thread_local`` mode
under a lock, so the replays and the capture do not disturb each
other); then one flip under the swap lock. In-flight batches finish on
the old version and no request is lost. ``serving.hot_swaps`` counts
swaps.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.dataset import Dataset
from ..device import DeviceLike, resolve_device
from ..telemetry.metrics import counter
from ..telemetry.watchdog import _padded_shape, arm_watchdog, disarm_watchdog
from ..workflow.env import execution_config
from .batcher import MicroBatcher, ShedError  # noqa: F401 - re-exported
from .ingress import IngressError, NdarrayIngress

_HOT_SWAPS = counter("serving.hot_swaps")


class CertificationError(RuntimeError):
    """The pipeline failed KP9xx certification: the runtime refuses to
    serve it."""


def _host(out) -> np.ndarray:
    """A pipeline's output as a host array: one copy off the device."""
    if hasattr(out, "array"):
        out = out.array
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class ServingRuntime:
    """One tenant's certified serving loop: ingress → bounded queue →
    ladder-coalesced dispatch → watchdog-checked apply. ``device``: where
    the stacked batches go (the card by default; without one this raises
    unless it is "cpu"); the fitted pipeline's tensors must be there."""

    def __init__(self, fitted, ingress=None, *,
                 envelope=None,
                 name: str = "fitted_pipeline",
                 element_shape=None,
                 hbm_budget_bytes: Optional[int] = None,
                 require_certified: bool = True,
                 device: DeviceLike = "cuda"):
        from ..analysis.serving import ServingEnvelope, envelope_from_env

        if element_shape is None and ingress is not None:
            element_shape = getattr(ingress, "shape", None)
        if element_shape is None:
            raise ValueError(
                "element_shape is required (or pass an NdarrayIngress "
                "that declares one) — the certificate is issued at a "
                "declared ingress element")
        self.device = resolve_device(device)
        self.element_shape = tuple(int(s) for s in element_shape)
        self.ingress = ingress or NdarrayIngress(self.element_shape)
        self.envelope = (envelope or envelope_from_env()
                         or ServingEnvelope())
        self.name = str(name)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.require_certified = bool(require_certified)
        self.certificate = None
        self.warmed_sites = 0
        self._fitted = fitted
        self._swap_lock = threading.Lock()
        self._dispatched_shapes: set = set()
        self._batcher: Optional[MicroBatcher] = None
        self._started = False

    # ------------------------------------------------------------ start

    def _certify(self, fitted):
        """KP9xx over the fitted apply graph at the declared element,
        propagated at the envelope's largest rung, so the KP905 price
        covers the largest batch a dispatch can bind."""
        from ..analysis.propagate import spec_pass
        from ..analysis.serving import ladder_shapes, serving_pass
        from ..analysis.specs import DataSpec, shape_struct

        worst = max(ladder_shapes(self.envelope))
        spec = DataSpec(element=shape_struct(self.element_shape,
                                             np.float32),
                        kind="dataset", count=worst)
        specs, _ = spec_pass(fitted.graph, {fitted.source: spec})
        cert, diags = serving_pass(
            fitted.graph, specs, self.envelope,
            source=fitted.source, sink=fitted.sink,
            hbm_budget_bytes=self.hbm_budget_bytes,
            label=self.name, ingress=self.ingress.describe())
        if self.require_certified and not cert.certified:
            from ..analysis.diagnostics import Severity

            errors = [f"{d.rule}: {d.message}" for d in diags
                      if d.severity >= Severity.ERROR]
            raise CertificationError(
                f"pipeline {self.name!r} failed KP9xx certification — "
                "refusing to serve. " + " | ".join(errors[:3]))
        return cert

    def _warm(self, fitted, manifest) -> int:
        """Every manifest site at every rung, on this thread."""
        from ..workflow.executor import warm_fitted_manifest

        sample = np.zeros((1,) + self.element_shape, np.float32)
        return warm_fitted_manifest(fitted, manifest, sample,
                                    device=self.device)

    def start(self) -> "ServingRuntime":
        if self._started:
            return self
        cert = self._certify(self._fitted)
        self.certificate = cert
        # the watchdog checks under the tag FittedPipeline.apply scopes
        # its requests with
        arm_watchdog(cert.as_record(), pipeline="fitted_pipeline")
        self.warmed_sites = self._warm(self._fitted, cert.manifest)
        self._record_handoff(cert)
        self._batcher = MicroBatcher(
            self._apply_batch, max_batch=self.envelope.max_batch,
            name=self.name).start()
        self._started = True
        return self

    def _record_handoff(self, cert) -> None:
        from ..analysis.serving import record_runtime_handoff

        cfg = execution_config()
        record_runtime_handoff(
            cert, self.name,
            warmed_sites=self.warmed_sites,
            queue_depth=cfg.serving_queue_depth,
            window_ms=cfg.serving_window_ms,
            coalesce=cfg.serving_coalesce)

    # --------------------------------------------------------- dispatch

    def _apply_batch(self, stacked: np.ndarray) -> np.ndarray:
        """One dispatch: the coalesced rows padded with zero rows to
        their rung (`_padded_shape`, the certified ladder: a ragged count
        of 3 or 11 replays the 4- or 16-row graph), copied to the device
        once, applied, and the riders' rows copied back once."""
        with self._swap_lock:
            fitted = self._fitted
        n = int(stacked.shape[0])
        target = _padded_shape(n)
        self._dispatched_shapes.add(target)
        if target > n:
            stacked = np.concatenate(
                [stacked, np.zeros((target - n,) + stacked.shape[1:],
                                   stacked.dtype)])
        out = fitted.apply(Dataset(np.ascontiguousarray(stacked),
                                   device=self.device))
        return _host(out)[:n]

    def submit(self, payload: Any, timeout: Optional[float] = 60.0
               ) -> np.ndarray:
        """Serve one request: checked at the declared ingress, coalesced
        onto the ladder; returns this request's row of the result.
        Raises `IngressError`, `ShedError` (queue full), or RuntimeError
        when the runtime is not started."""
        if not self._started or self._batcher is None:
            raise RuntimeError(f"runtime {self.name!r} is not started")
        row = self.ingress.accept(payload)
        if tuple(row.shape) != self.element_shape:
            raise IngressError(
                f"ingress produced shape {tuple(row.shape)}, certified "
                f"element is {self.element_shape}")
        return self._batcher.submit(row, timeout=timeout)

    # --------------------------------------------------------- hot swap

    def swap(self, new_fitted) -> None:
        """Hot swap: certify the new version, warm every rung of it while
        traffic goes on on the old one, then flip atomically. In-flight
        batches complete on the old pipeline."""
        cert = self._certify(new_fitted)
        warmed = self._warm(new_fitted, cert.manifest)
        with self._swap_lock:
            self._fitted = new_fitted
            self.certificate = cert
            self.warmed_sites = warmed
        arm_watchdog(cert.as_record(), pipeline="fitted_pipeline")
        self._record_handoff(cert)
        _HOT_SWAPS.inc()

    def swap_from(self, path: str) -> None:
        """Hot swap from a saved fitted pipeline, loaded onto this
        runtime's device."""
        from ..workflow.pipeline import FittedPipeline

        self.swap(FittedPipeline.load(path, device=self.device))

    # ------------------------------------------------------------- stop

    def stop(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None
        disarm_watchdog()
        self._started = False

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, Any]:
        from ..analysis.serving import ladder_shapes

        ladder = ladder_shapes(self.envelope)
        return {
            "name": self.name,
            "started": self._started,
            "certified": bool(self.certificate
                              and self.certificate.certified),
            "warmed_sites": self.warmed_sites,
            "ladder": list(ladder),
            "dispatched_shapes": sorted(self._dispatched_shapes),
            "dispatched_outside_ladder": sorted(
                self._dispatched_shapes - set(ladder)),
            "element_shape": list(self.element_shape),
            "ingress": self.ingress.describe(),
        }
