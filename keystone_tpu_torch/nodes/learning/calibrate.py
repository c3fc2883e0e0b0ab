"""Cost-model calibration on the device.

Counterpart of `keystone_tpu/nodes/learning/calibrate.py` (`:32-303`).
The reference's cost weights were fit once on a 16-node r3.4xlarge
cluster (LeastSquaresEstimator.scala:17, :190-192); here they are a
library call that times the three resources a solver uses on the live
device and returns seconds a unit for `CostModel.cost`.

The probes keep JAX's design (`:60-110`): a step applied to its own
output N times and 2N times, the two times differenced so the fixed cost
of a call cancels, each the median of 3. On the card the times are CUDA
events around the chained launches; on the CPU the host clock.

- compute: a square fp32 GEMM, ``x @ a / D``, with TF32 off (the port's
  float32 contract, `device.py`), 2·D³ flops a step;
- memory: an elementwise read and write pass, ``x * 1.000001``, over a
  ``mem_mb`` buffer, 8 bytes an element a step;
- network: the port runs on one device, so there is nothing to measure,
  and the weight returned is the resolved one (the analytic NVLink rate
  on the card), as JAX's is on a one-device mesh (`:138-139`);
- host↔device: the best of a few copies of a pinned ``mem_mb`` host
  buffer to the device (a host copy on the CPU).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from . import cost_model

log = logging.getLogger(__name__)

#: analytic host↔device rates (B/s) where no measured file applies: a
#: host memcpy on the CPU; on the card PCIe 5.0 x16's 64 GB/s a
#: direction (published; not measured)
CPU_HOST_BW = 8.0e9
ANALYTIC_HOST_BW = 64.0e9


@dataclass
class CostWeights:
    cpu_weight: float      # seconds a FLOP
    mem_weight: float      # seconds a device-memory byte touched
    network_weight: float  # seconds a byte moved between devices
    #: the rates the same probes imply (FLOP/s, B/s); 0.0 resolves to
    #: the weights' reciprocals
    peak_flops: float = 0.0
    peak_bw: float = 0.0
    #: host↔device B/s; 0.0 means not measured (`host_bandwidth`)
    host_bw: float = 0.0

    def __post_init__(self):
        if not self.peak_flops and self.cpu_weight > 0:
            self.peak_flops = 1.0 / self.cpu_weight
        if not self.peak_bw and self.mem_weight > 0:
            self.peak_bw = 1.0 / self.mem_weight


def _time_chained(step, x0: torch.Tensor, iters: int) -> float:
    """Seconds a step of ``step`` applied to its own output: the chain
    timed at ``iters`` and ``2·iters`` steps (median of 3 each) and
    differenced, which cancels the fixed cost of a run."""
    cuda = x0.device.type == "cuda"

    def run(n):
        x = x0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = step(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        return time.perf_counter() - t0

    run(iters), run(2 * iters)  # warm
    t1 = np.median([run(iters) for _ in range(3)])
    t2 = np.median([run(2 * iters) for _ in range(3)])
    return float(t2 - t1) / iters


def _probe(step, x0, iters: int, fallback: float, name: str) -> float:
    """Differenced seconds a step; a difference at or below 0 is noise:
    retried once at 4× the steps, then the fallback with a warning
    (`:91-110`)."""
    t = _time_chained(step, x0, iters)
    if t <= 0.0:
        t = _time_chained(step, x0, 4 * iters)
    if t <= 0.0:
        log.warning("cost-model %s probe was noise (differenced time "
                    "<= 0); keeping the resolved weight", name)
        return fallback
    return t


def calibrate_cost_weights(device: DeviceLike = "cuda", gemm_dim: int = 2048,
                           mem_mb: int = 64, iters: int = 8) -> CostWeights:
    """(cpu, mem, network) weights measured on ``device``; the network
    weight is the resolved one (one device: nothing to measure)."""
    dev = resolve_device(device)
    a = torch.ones((gemm_dim, gemm_dim), dtype=torch.float32, device=dev)
    flops = 2.0 * gemm_dim**3
    t_gemm = _probe(lambda x: x @ a / gemm_dim, a, iters,
                    cost_model.CPU_WEIGHT * flops, "cpu")
    n = mem_mb * (1 << 20) // 4
    v = torch.ones((n,), dtype=torch.float32, device=dev)
    nbytes = 2.0 * 4.0 * n
    t_mem = _probe(lambda x: x * 1.000001, v, iters,
                   cost_model.MEM_WEIGHT * nbytes, "mem")
    return CostWeights(t_gemm / flops, t_mem / nbytes,
                       cost_model.NETWORK_WEIGHT,
                       host_bw=_probe_host_bw(mem_mb, device=dev))


def _probe_host_bw(mem_mb: int = 64, reps: int = 3,
                   device: DeviceLike = "cuda") -> float:
    """Host→device B/s: the best of ``reps`` copies of a fresh pinned
    host buffer (a host copy on the CPU), the first copy a warm-up. The
    best, not the median: page faults and allocator warm-up only slow a
    copy down. 0.0 (not measured) if a copy fails."""
    dev = resolve_device(device)
    n = mem_mb * (1 << 20) // 4
    try:
        src = torch.ones((n,), dtype=torch.float32,
                         pin_memory=dev.type == "cuda")
        best = float("inf")
        for _ in range(reps + 1):
            src += 1.0
            t0 = time.perf_counter()
            if dev.type == "cuda":
                src.to(dev, non_blocking=True)
                torch.cuda.synchronize(dev)
            else:
                src.clone()
            best = min(best, time.perf_counter() - t0)
    except RuntimeError as e:
        log.warning("host bandwidth probe failed: %s", e)
        return 0.0
    return 4.0 * n / best if best > 0 else 0.0


def default_weights() -> CostWeights:
    return CostWeights(cost_model.CPU_WEIGHT, cost_model.MEM_WEIGHT,
                       cost_model.NETWORK_WEIGHT)


def write_calibration(path: str, weights: CostWeights,
                      provenance: "dict | None" = None) -> dict:
    """Write ``weights`` in the schema `cost_model.resolve_weights`
    reads; the provenance records the live platform first, then
    ``provenance``. Returns the payload."""
    prov = {"platform": cost_model.live_platform(),
            "date": datetime.date.today().isoformat(),
            "torch": torch.__version__}
    prov.update(provenance or {})
    payload = {
        "cpu_weight": float(weights.cpu_weight),
        "mem_weight": float(weights.mem_weight),
        "network_weight": float(weights.network_weight),
        "peak_flops": float(weights.peak_flops),
        "peak_bw": float(weights.peak_bw),
        "host_bw": float(weights.host_bw),
        "network_weight_measured": False,
        "provenance": prov,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return payload


def machine_rates() -> "tuple[float, float]":
    """(peak FLOP/s, peak B/s): the resolved weights' reciprocals (on
    the CPU without a measured file, the CPU analytic rates)."""
    cw, mw, _ = cost_model.resolve_weights()
    return 1.0 / cw, 1.0 / mw


def host_bandwidth() -> float:
    """Host↔device B/s: a calibration file's ``host_bw`` where it applies
    (by `cost_model`'s rules), else the platform's analytic rate."""
    mode = os.environ.get("KEYSTONE_COST_CALIBRATION", "")
    live = cost_model.live_platform()
    if mode != "analytic":
        try:
            cal, platform = cost_model.read_calibration(
                cost_model.calibration_path())
            if float(cal.get("host_bw", 0.0)) > 0 and (
                    mode == "force" or platform == live):
                return float(cal["host_bw"])
        except (OSError, ValueError, TypeError, AttributeError):
            pass  # no usable file: the analytic rate
    return CPU_HOST_BW if live == "cpu" else ANALYTIC_HOST_BW
