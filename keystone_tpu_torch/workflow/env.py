"""Process-wide pipeline state: the execution config, the prefix table
and the optimizer.

Counterpart of `keystone_tpu/workflow/env.py:35-500` (`ExecutionConfig`,
`execution_config`, `set_execution_config`, `set_planned_chunk_size`,
`planned_chunk_size`, `resolved_chunk_size`, `overlap_override`,
`dispatch_override`, `config_override`) and `:504-606` (reference
workflow/{Prefix,PipelineEnv}.scala). A node's `Prefix` is the structural
identity of its ancestry; `PipelineEnv.state` maps the prefixes of
saveable nodes (estimators, `Cacher`s) to the `Expression`s that computed
them, so a later pipeline that holds the same prefix reuses the fit or
the cached dataset instead of recomputing it.

`ExecutionConfig` keeps only the knobs the port reads, with the JAX
package's names and environment variables. They change when and how work
is dispatched (overlapped host staging, the concurrent scheduler, the
chunking, warm-ups, megafusion) and what the telemetry records (the
trace, the ledger, the live plane); the same kernels run either way. The
JAX package's compile-cache, planner, serving and spill fields have no
counterpart, nor has ``pallas_kernels``: the port has no switch that
picks a plain kernel path.

The table keeps every saved expression alive, and with it its tensors on
the device: `PipelineEnv.reset()` drops them.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from .expressions import Expression
from .graph import Graph, NodeId, SourceId


# --------------------------------------------------------------------------
# Execution configuration


@dataclass(frozen=True)
class ExecutionConfig:
    """Dispatch knobs (`keystone_tpu/workflow/env.py:35-305`).

    ``overlap`` (env ``KEYSTONE_OVERLAP``, default on): host items are
    stacked and copied to the card by a producer thread one chunk ahead
    of the chunk the card runs (`utils/batching.py::_stream_overlapped`),
    loaders prefetch through a bounded queue, and forced expressions
    stream chunks to chunk-capable consumers. Single-chunk inputs take
    the serial path.

    ``prefetch_depth`` (``KEYSTONE_PREFETCH_DEPTH``, default 2) bounds
    every background queue and the in-flight result window: at most
    2·depth + 2 chunks are resident a stream.

    ``concurrent_dispatch`` (``KEYSTONE_CONCURRENT_DISPATCH``, default
    off, where the JAX package's is on) and ``dispatch_workers``
    (``KEYSTONE_DISPATCH_WORKERS``, default 4; 1 or less is serial): the
    executor forces independent subgraphs on a bounded worker pool
    (`GraphExecutor._force_concurrent`). On the card the branches' work
    is host Python under one interpreter lock and kernels on one stream,
    so the pool overlaps little: it made ImageNetSiftLcsFV's run 0.18 s
    slower and VOCSIFTFisher's peak memory 1.2 GB higher (PERF.md).

    ``chunk_size`` (``KEYSTONE_CHUNK_SIZE``) is the host batching's chunk
    of items. Its default is 1024, not the JAX package's 256: it bounds
    the descriptor extractors' intermediates on the card (about 20 floats
    a pixel for SIFT), and VOC's K4 launches, one a chunk, rest on it.
    Outputs do not depend on it.

    ``pad_chunks`` (``KEYSTONE_PAD_CHUNKS``, default on): a bucket's
    ragged tail chunk is zero-padded to the chunk size (a power-of-two
    ladder below it for small buckets), so the rows a batched call sees
    take few values: one CUDA graph serves each. Padded rows are sliced
    off before anyone sees them.

    ``aot_warmup`` (``KEYSTONE_AOT_WARMUP``, default off, where the JAX
    package's is on): the executor warms its plan's fused chains on a
    background thread: launch plans by one eager run, and a fitted or
    loaded pipeline's megafused chain captured
    (`GraphExecutor._warm_plan`). There is no compile to hide on the
    card, and a warm-up's host work contends with the force for the
    interpreter lock, so it pays only where a kept pipeline is warmed
    before it is applied (a server before its traffic).

    ``megafusion`` (``KEYSTONE_MEGAFUSION``, default on): the optimizer's
    `MegafusionRule` collapses a fan-out-free apply path of fused
    members into one `MegafusedPlanOperator`, whose padded chunk loop
    runs eagerly at its first call at a rung and as one CUDA graph
    replay once captured (at the second), and host streams of fused
    batch functions run a bucket's chunks as one such loop. Read at
    optimization and dispatch time.
    """

    overlap: bool = True
    prefetch_depth: int = 2
    concurrent_dispatch: bool = False
    dispatch_workers: int = 4
    chunk_size: int = 1024
    pad_chunks: bool = True
    aot_warmup: bool = False
    megafusion: bool = True
    trace_path: Optional[str] = None
    ledger_path: Optional[str] = None
    live_telemetry: bool = True


_exec_config: Optional[ExecutionConfig] = None

_OFF = ("0", "false", "off")


def _env_on(name: str, default: bool = True) -> bool:
    value = os.environ.get(name)
    return default if value is None else value.lower() not in _OFF


def execution_config() -> ExecutionConfig:
    """The process's config, read from the environment at first use."""
    global _exec_config
    if _exec_config is None:
        _exec_config = ExecutionConfig(
            overlap=_env_on("KEYSTONE_OVERLAP"),
            prefetch_depth=max(1, int(os.environ.get(
                "KEYSTONE_PREFETCH_DEPTH", "2"))),
            concurrent_dispatch=_env_on("KEYSTONE_CONCURRENT_DISPATCH",
                                        False),
            dispatch_workers=max(1, int(os.environ.get(
                "KEYSTONE_DISPATCH_WORKERS", "4"))),
            chunk_size=max(1, int(os.environ.get(
                "KEYSTONE_CHUNK_SIZE", "1024"))),
            pad_chunks=_env_on("KEYSTONE_PAD_CHUNKS"),
            aot_warmup=_env_on("KEYSTONE_AOT_WARMUP", False),
            megafusion=_env_on("KEYSTONE_MEGAFUSION"),
            trace_path=os.environ.get("KEYSTONE_TRACE") or None,
            ledger_path=os.environ.get("KEYSTONE_LEDGER") or None,
            live_telemetry=_env_on("KEYSTONE_LIVE_TELEMETRY"),
        )
    return _exec_config


def set_execution_config(config: Optional[ExecutionConfig]) -> None:
    """Install ``config`` process-wide; None re-derives from the env."""
    global _exec_config
    _exec_config = config


#: a planner's chunk decision, or None (`:351-383`). The port has no
#: planner that sets it; the seam is kept so the batching and a later
#: planner read one resolution.
_planned_chunk: Optional[int] = None


def set_planned_chunk_size(chunk: Optional[int]) -> None:
    """Install (or clear, with None) a planner's chunk decision."""
    global _planned_chunk
    _planned_chunk = max(1, int(chunk)) if chunk is not None else None


def planned_chunk_size() -> Optional[int]:
    return _planned_chunk


def resolved_chunk_size() -> int:
    """The chunk the host batching uses: a planner's decision where one
    is installed, else ``ExecutionConfig.chunk_size``."""
    planned = planned_chunk_size()
    return planned if planned is not None else execution_config().chunk_size


@contextmanager
def config_override(**fields):
    """Scoped override of `ExecutionConfig` fields."""
    global _exec_config
    prev = _exec_config
    cfg = replace(execution_config(), **fields)
    _exec_config = cfg
    try:
        yield cfg
    finally:
        _exec_config = prev


@contextmanager
def overlap_override(enabled: bool, prefetch_depth: Optional[int] = None):
    """Scoped overlap toggle (and depth)."""
    fields = dict(overlap=enabled)
    if prefetch_depth is not None:
        fields["prefetch_depth"] = max(1, prefetch_depth)
    with config_override(**fields) as cfg:
        yield cfg


@contextmanager
def dispatch_override(enabled: bool, workers: Optional[int] = None):
    """Scoped concurrent-dispatch toggle (and worker count)."""
    fields = dict(concurrent_dispatch=enabled)
    if workers is not None:
        fields["dispatch_workers"] = max(1, workers)
    with config_override(**fields) as cfg:
        yield cfg



@dataclass(frozen=True)
class Prefix:
    """Structural identity of a node's ancestry (Prefix.scala:4-30)."""

    operator_key: Tuple
    dep_prefixes: Tuple["Prefix", ...]


def compute_prefix(graph: Graph, node: NodeId, _memo=None) -> Optional[Prefix]:
    """Prefix of ``node``, or None if any ancestor is an unbound source
    (unbound ancestry has no stable identity, Prefix.scala:13-27)."""
    if _memo is None:
        _memo = {}
    if node in _memo:
        return _memo[node]
    dep_prefixes = []
    for d in graph.get_dependencies(node):
        if isinstance(d, SourceId):
            _memo[node] = None
            return None
        dp = compute_prefix(graph, d, _memo)
        if dp is None:
            _memo[node] = None
            return None
        dep_prefixes.append(dp)
    p = Prefix(graph.get_operator(node).prefix_key(), tuple(dep_prefixes))
    _memo[node] = p
    return p


class PipelineEnv:
    """Process-wide state: the prefix → Expression table and the current
    optimizer (PipelineEnv.scala:7-45). ``reset()`` drops both."""

    _instance: Optional["PipelineEnv"] = None

    def __init__(self):
        self.state: Dict[Prefix, Expression] = {}
        self._optimizer = None
        #: a node-force profiler (`utils/profiling.py::ExecutionProfiler`)
        #: while one is installed, else None
        self.profiler = None

    @classmethod
    def get(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    def get_optimizer(self):
        if self._optimizer is None:
            from .optimizer import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    def set_optimizer(self, optimizer) -> None:
        self._optimizer = optimizer

    @classmethod
    def reset(cls) -> None:
        cls._instance = None


class IdentityKey:
    """Hashable wrapper keying on *object identity* while holding a strong
    reference, so a garbage-collected object's address can never be reused
    by a different object and collide in the prefix table."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, IdentityKey) and other.obj is self.obj

    def __repr__(self) -> str:
        return f"IdentityKey({type(self.obj).__name__}@{id(self.obj):#x})"


def _operator_prefix_key(self) -> Tuple:
    """Default operator identity for prefix and CSE purposes: object
    identity. The reference relies on Scala case-class equality; here an
    operator carrying fitted state or closures is equal only to itself,
    the sharing pattern the reference exploits (the same node object
    reused across pipeline graphs). A `DatasetOperator` is keyed on its
    dataset, a `DatumOperator` on its datum."""
    return (type(self).__qualname__, IdentityKey(self))


# Attach the default prefix_key to Operator without circular imports.
from .operators import DatasetOperator, DatumOperator, Operator  # noqa: E402

Operator.prefix_key = _operator_prefix_key
DatasetOperator.prefix_key = lambda self: ("Dataset", IdentityKey(self.dataset))
DatumOperator.prefix_key = lambda self: ("Datum", IdentityKey(self.datum))
