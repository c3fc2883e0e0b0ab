"""Solver cost models for node-level solver choice.

Counterpart of `keystone_tpu/nodes/learning/cost_model.py` (`:26-254`;
reference nodes/learning/CostModel.scala:6-16 and the per-solver models
of LeastSquaresEstimator.scala, LinearMapper.scala, LBFGS.scala and
BlockLinearMapper.scala). A cost is cpu_weight·flops + mem_weight·bytes
+ network_weight·bytes moved between devices, in seconds. The formulas
(`CostProfile`, `ExactSolverCostModel`, `BlockSolverCostModel`,
`LBFGSCostModel`, `:204-254`) are JAX's, term for term.

Weight resolution follows JAX's rules (`:84-176`):

- a measured calibration file (``cuda_calibration.json`` beside this
  module, written by `calibrate.write_calibration` from a run of
  `calibrate.calibrate_cost_weights` on the card) applies only when the
  device it was measured on is the live one: its provenance's
  ``platform`` equals `live_platform()`, the name of the current CUDA
  device, or ``"cpu"`` without one;
- otherwise the analytic weights of the live platform;
- ``KEYSTONE_COST_CALIBRATION=analytic`` ignores the file,
  ``=force`` applies it whatever the platform, and any other value is
  the path of a calibration file read instead of the committed one
  (the platform check still applies; a missing path warns).

JAX's analytic constants are TPU v5e rates and are not used here. The
card's analytic weights are the NVIDIA H100 SXM's published peaks at
its 700 W limit: 67 TFLOP/s of true float32 outside the tensor cores
(the port keeps TF32 off, `device.py`), 3.35 TB/s of HBM3, and for the
network weight the 450 GB/s a direction of fourth-generation NVLink,
which no run of this repository has measured. On the CPU the analytic
weights are the order-of-magnitude host of `calibrate.py` (JAX's
`calibrate.py:234-235`): 50 GFLOP/s and a 20 GB/s memory stream, a
gather between processes of one host being a copy at that rate.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

import torch

log = logging.getLogger(__name__)


@dataclass
class CostProfile:
    """Workload statistics measured from a sample (n, d, k, sparsity)
    and the device count (≈ numMachines, a plain parameter so tests can
    price a 16-device cluster without one,
    LeastSquaresEstimatorSuite.scala:18-37)."""

    n: int
    d: int
    k: int
    sparsity: float
    num_chips: int


# NVIDIA H100 SXM data sheet (dense rates), 700 W: fp32 outside the
# tensor cores, HBM3, and NVLink 4 a direction (network: not measured)
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12
H100_NVLINK_BYTES = 450e9
ANALYTIC_CUDA = (1.0 / H100_FP32_FLOPS, 1.0 / H100_HBM_BYTES,
                 1.0 / H100_NVLINK_BYTES)

# an order-of-magnitude few-core AVX host (`calibrate.py` in JAX)
CPU_PEAK_FLOPS = 5.0e10
CPU_PEAK_BW = 2.0e10
ANALYTIC_CPU = (1.0 / CPU_PEAK_FLOPS, 1.0 / CPU_PEAK_BW, 1.0 / CPU_PEAK_BW)

CALIBRATION_FILE = os.path.join(os.path.dirname(__file__),
                                "cuda_calibration.json")

_weights_cache = None


def live_platform() -> str:
    """The name of the current CUDA device (as
    ``torch.cuda.get_device_name``), or ``"cpu"`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


def analytic_weights(platform: str = None):
    """(cpu, mem, network) analytic weights of ``platform`` (default:
    the live one): the CPU's for ``"cpu"``, else the H100's."""
    platform = live_platform() if platform is None else platform
    return ANALYTIC_CPU if platform == "cpu" else ANALYTIC_CUDA


def calibration_path() -> str:
    """The calibration file that resolution reads: the committed one, or
    the path ``KEYSTONE_COST_CALIBRATION`` names."""
    mode = os.environ.get("KEYSTONE_COST_CALIBRATION", "")
    return CALIBRATION_FILE if mode in ("", "force", "analytic") else mode


def read_calibration(path: str):
    """(payload, its provenance's platform) of a calibration file."""
    with open(path) as f:
        cal = json.load(f)
    prov = cal.get("provenance")
    return cal, prov.get("platform") if isinstance(prov, dict) else None


def resolve_weights():
    """(cpu, mem, network) weights by the rules of the module docstring,
    cached on (mode, live platform)."""
    global _weights_cache
    mode = os.environ.get("KEYSTONE_COST_CALIBRATION", "")
    live = live_platform()
    key = (mode, live)
    if _weights_cache is not None and _weights_cache[0] == key:
        return _weights_cache[1]
    weights = _resolve(mode, live)
    _weights_cache = (key, weights)
    return weights


def _resolve(mode: str, live: str):
    analytic = analytic_weights(live)
    if mode == "analytic":
        return analytic
    path = calibration_path()
    try:
        cal, cal_platform = read_calibration(path)
        weights = (float(cal["cpu_weight"]), float(cal["mem_weight"]),
                   float(cal["network_weight"]))
    except FileNotFoundError:
        if path != CALIBRATION_FILE:
            log.warning("KEYSTONE_COST_CALIBRATION=%s does not exist; "
                        "using analytic weights", path)
        return analytic
    except (OSError, KeyError, ValueError, TypeError, AttributeError) as e:
        log.warning("cost-model calibration file %s failed to parse (%s); "
                    "using analytic weights", path, e)
        return analytic
    if mode != "force" and cal_platform != live:
        log.info("cost-model calibration was measured on %r, the live "
                 "device is %r; using analytic weights "
                 "(KEYSTONE_COST_CALIBRATION=force to override)",
                 cal_platform, live)
        return analytic
    return weights


def __getattr__(name):
    # CPU_WEIGHT, MEM_WEIGHT, NETWORK_WEIGHT resolve at first access
    idx = {"CPU_WEIGHT": 0, "MEM_WEIGHT": 1, "NETWORK_WEIGHT": 2}.get(name)
    if idx is None:
        raise AttributeError(name)
    return resolve_weights()[idx]


class CostModel:
    """cost(profile) -> estimated seconds (CostModel.scala:6-16)."""

    def cost(self, p: CostProfile, cpu_weight: float = None,
             mem_weight: float = None, network_weight: float = None) -> float:
        raise NotImplementedError

    @staticmethod
    def _weights(cpu_weight, mem_weight, network_weight):
        if None not in (cpu_weight, mem_weight, network_weight):
            return cpu_weight, mem_weight, network_weight
        cw, mw, nw = resolve_weights()
        return (cw if cpu_weight is None else cpu_weight,
                mw if mem_weight is None else mem_weight,
                nw if network_weight is None else network_weight)


class ExactSolverCostModel(CostModel):
    """Normal equations: XᵀX flops n·d²/chips + a d³ solve (replicated)
    + a d² all-reduce (LinearMapper.scala cost model)."""

    def cost(self, p, cpu_weight=None, mem_weight=None, network_weight=None):
        cpu_weight, mem_weight, network_weight = self._weights(
            cpu_weight, mem_weight, network_weight)
        flops = 2.0 * p.n * p.d * p.d / p.num_chips + 2.0 * p.d**3
        mem = 4.0 * (p.n * p.d / p.num_chips + p.d * p.d)
        net = 4.0 * p.d * p.d
        return cpu_weight * flops + mem_weight * mem + network_weight * net


class BlockSolverCostModel(CostModel):
    """BCD: numIter sweeps of a per-block Gram (n·B·(B+k)/chips), B³
    solves and B·(B+k) all-reduces (BlockLinearMapper.scala cost
    model)."""

    def __init__(self, block_size: int = 4096, num_iter: int = 1):
        self.block_size = block_size
        self.num_iter = num_iter

    def cost(self, p, cpu_weight=None, mem_weight=None, network_weight=None):
        cpu_weight, mem_weight, network_weight = self._weights(
            cpu_weight, mem_weight, network_weight)
        B = min(self.block_size, p.d)
        nb = -(-p.d // B)
        per_sweep_flops = nb * (
            2.0 * p.n * B * (B + 2 * p.k) / p.num_chips + (2.0 / 3.0) * B**3)
        mem = 4.0 * self.num_iter * nb * (p.n * (B + p.k) / p.num_chips)
        net = 4.0 * self.num_iter * nb * B * (B + p.k)
        return (cpu_weight * self.num_iter * per_sweep_flops
                + mem_weight * mem + network_weight * net)


class LBFGSCostModel(CostModel):
    """numIters gradient passes of 2·n·d·k flops each over the chips and
    a d·k model all-reduce an iteration (LBFGS.scala cost model); the
    sparse variant scales the passes by the density."""

    def __init__(self, num_iters: int = 20, sparse: bool = False):
        self.num_iters = num_iters
        self.sparse = sparse

    def cost(self, p, cpu_weight=None, mem_weight=None, network_weight=None):
        cpu_weight, mem_weight, network_weight = self._weights(
            cpu_weight, mem_weight, network_weight)
        density = p.sparsity if self.sparse else 1.0
        flops = self.num_iters * 4.0 * p.n * p.d * p.k * density / p.num_chips
        mem = 4.0 * self.num_iters * (p.n * p.d * density / p.num_chips
                                      + p.d * p.k)
        net = 4.0 * self.num_iters * p.d * p.k
        return cpu_weight * flops + mem_weight * mem + network_weight * net
