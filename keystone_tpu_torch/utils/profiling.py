"""Execution profiling: seconds and output bytes of every node forced.

Counterpart of `keystone_tpu/utils/profiling.py:1-108`:

    with profile_execution() as prof:
        pipeline(data).get()
    print(prof.report())

A consumer of the shared node-force instrumentation
(`telemetry/instrument.py`): `GraphExecutor` wraps each node's lazy
Expression once while a profiler is installed on `PipelineEnv`, and the
wrapper reports each force here through `on_force`, the same stream
that feeds spans, the metrics registry and `autocache.profile_nodes`.
With a profiler attached each force is closed by a device sync, so the
card's work lands on the node that queued it; a thunk that raises keeps
its elapsed time and counts a failure.

Two counters of what a call does on the card, for the benches and the
chip smoke script: `count_syncs` (the calls that waited for the card,
by source line) and `launch_counts` (every kernel wrapper's launches).
"""

from __future__ import annotations

import collections
import os
import traceback
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..telemetry.instrument import instrument_node_force
from ..workflow.env import PipelineEnv
from ..workflow.expressions import Expression


@dataclass
class NodeProfile:
    label: str
    seconds: float = 0.0
    bytes: float = 0.0
    forced: int = 0
    failures: int = 0


class ExecutionProfiler:
    """Per-label (and, when the executor supplies one, per-vertex)
    aggregation of node-force completions."""

    def __init__(self):
        self.profiles: Dict[str, NodeProfile] = {}
        #: per-vertex-id profiles for consumers that need graph-keyed
        #: measurements (`autocache.profile_nodes`); labels may collide
        #: across a graph, vertex ids within one graph cannot
        self.by_vertex: Dict[int, NodeProfile] = {}

    # ------------------------------------------------- span consumption

    def on_force(self, label: str, seconds: float, nbytes: float,
                 failed: bool = False, vertex: Optional[int] = None) -> None:
        """One node force completed (the shared instrumentation calls
        this from its try/finally, so failed forces still report their
        elapsed time)."""
        p = self.profiles.setdefault(label, NodeProfile(label))
        p.seconds += seconds
        p.forced += 1
        if failed:
            p.failures += 1
        else:
            p.bytes += nbytes
        if vertex is not None:
            v = self.by_vertex.setdefault(vertex, NodeProfile(label))
            v.seconds += seconds
            v.forced += 1
            if failed:
                v.failures += 1
            else:
                v.bytes += nbytes

    # ------------------------------------------------------- public API

    def wrap(self, label: str, expr: Expression) -> Expression:
        """Wrap ``expr``'s thunk so its force reports here (kept public
        API; the executor now calls the shared instrumentation directly
        and passes the vertex id along)."""
        return instrument_node_force(label, expr, profiler=self)

    def report(self) -> str:
        rows = sorted(self.profiles.values(), key=lambda p: -p.seconds)
        lines = [f"{'node':<44} {'seconds':>9} {'MB':>9} {'forced':>6}"]
        for p in rows:
            fail = f" ({p.failures} failed)" if p.failures else ""
            lines.append(
                f"{p.label[:44]:<44} {p.seconds:>9.3f} {p.bytes / 1e6:>9.1f} "
                f"{p.forced:>6}{fail}"
            )
        return "\n".join(lines)


@contextmanager
def profile_execution():
    env = PipelineEnv.get()
    prof = ExecutionProfiler()
    prev = getattr(env, "profiler", None)
    env.profiler = prof
    try:
        yield prof
    finally:
        env.profiler = prev


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def count_syncs(fn: Callable[[], object]) -> Tuple[Dict[str, int], int]:
    """({source line: count}, total) of the calls in ``fn`` that wait for
    the card, as torch's sync debug mode reports them. Each is named by
    the innermost frame of the call's stack in this repository, where
    one exists (the frame of the port's call into torch), else by the
    warning's own frame. Needs a card."""
    import torch

    lines: collections.Counter = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(_REPO + os.sep)]
        where = (ours[-1].filename, ours[-1].lineno) if ours else (
            filename, lineno)
        lines[f"{os.path.relpath(where[0], _REPO)}:{where[1]}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        # installed after the mode is set: with torch 2.11 the first
        # switch to "warn" is itself reported as a synchronizing call,
        # and it is no call of ``fn``
        warnings.showwarning = record
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(lines), sum(lines.values())


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from ..ops import chain_kernels, kernels

    return {w.__name__: w.launches for w in (
        kernels.conv_rectify_pool, kernels.rectify_pool,
        kernels.rectify_pool_vectorize, kernels.rbf_block, kernels.rbf_split,
        chain_kernels.elementwise_chain)}
