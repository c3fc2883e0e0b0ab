"""The kernel wrappers' meta branch.

The static analyzer (`analysis/specs.py`, `analysis/roofline.py`) runs
stage bodies on tensors on torch's ``meta`` device: shapes and dtypes,
no storage. A kernel wrapper given a meta tensor returns an empty meta
tensor of its output's shape and dtype, launches nothing, counts no
launch, and reports the work the kernel would do on those shapes (its
FLOPs and the bytes it must move, each input read once and each output
written once: the bound formulas of PERF.md §6) to every cost collector
open on this thread (`collect_costs`). A meta tensor holds no data, so
no request reaches this branch; a CUDA tensor still launches its kernel
or raises, and a CPU tensor still runs the plain version.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator

import torch

_local = threading.local()


class MetaCosts:
    """What the kernels' meta branches reported while it was open."""

    def __init__(self):
        self.flops = 0.0
        self.nbytes = 0.0
        self.calls: Dict[str, int] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += float(flops)
        self.nbytes += float(nbytes)
        self.calls[name] = self.calls.get(name, 0) + 1


@contextmanager
def collect_costs() -> Iterator[MetaCosts]:
    """Collect the meta branches' reports on this thread."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    costs = MetaCosts()
    stack.append(costs)
    try:
        yield costs
    finally:
        stack.remove(costs)


def report(name: str, flops: float, nbytes: float) -> None:
    """A meta branch's work, to every collector open on this thread."""
    for costs in getattr(_local, "stack", ()):
        costs.add(name, flops, nbytes)


def empty(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")
