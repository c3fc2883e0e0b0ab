"""Lazy memoized graph execution.

Counterpart of the serial path of `keystone_tpu/workflow/executor.py`
(`GraphExecutor`, `:233-720`; reference workflow/GraphExecutor.scala:
14-81): executing a graph up to a `GraphId` optimizes the graph once
(lazily, with the process-wide optimizer), runs the structural check,
then evaluates dependencies recursively with one memo entry per vertex.
Results of nodes whose prefixes the optimizer marked saveable go into
`PipelineEnv.state`, so later executors reuse them: an estimator is fit
once (GraphExecutor.scala:65-71). The JAX package's concurrent
scheduler, AOT warm-ups and static estimates (`:71-232, 301-672,
722-940`) have no counterpart yet.

While a profiler is installed on `PipelineEnv` (`autocache.profile_nodes`
installs one), each node's force is timed, closed by a device sync so
the card's work lands on the node that queued it, and its output's bytes
are counted.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from .env import PipelineEnv, Prefix
from .expressions import Expression
from .graph import Graph, GraphId, NodeId, SinkId, SourceId


def value_bytes(value) -> float:
    """Bytes a forced value holds: its tensors' (a dataset's rows, a
    host dataset's stacked buckets, a host CSR's arrays), 0 for others."""
    if isinstance(value, torch.Tensor):
        return float(value.numel() * value.element_size())
    if isinstance(value, (tuple, list)):
        return float(sum(value_bytes(v) for v in value))
    buckets = getattr(value, "_buckets", None)
    if buckets is not None:
        return float(sum(value_bytes(t) for _, t in buckets))
    matrix = getattr(value, "matrix", None)
    if matrix is not None and hasattr(matrix, "indptr"):
        return float(matrix.data.nbytes + matrix.indices.nbytes
                     + matrix.indptr.nbytes)
    data = getattr(value, "data", None)
    if data is not None and data is not value:
        return value_bytes(data)
    return 0.0


def _sync_value(value) -> None:
    """Wait until the device has produced ``value``."""
    device = getattr(value, "device", None)
    if isinstance(value, torch.Tensor):
        device = value.device
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device) and device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(label: str, vertex: int, expr: Expression, profiler):
    """``expr`` with its force reported to ``profiler``: seconds (closed
    by a device sync) and output bytes."""
    thunk = expr._thunk
    if thunk is None:  # already forced: nothing to time
        return expr

    def forced():
        t0 = time.perf_counter()
        value = thunk()
        _sync_value(value)
        profiler.on_force(label, time.perf_counter() - t0,
                          value_bytes(value), vertex)
        return value

    expr._thunk = forced
    return expr


class GraphExecutor:
    def __init__(self, graph: Graph, optimize: bool = True,
                 plan: Optional[Tuple[Graph, Dict[NodeId, Prefix]]] = None):
        """``plan`` supplies an already-optimized (graph, prefixes) pair
        and bypasses the optimizer (`Pipeline.fit` uses it)."""
        self._raw_graph = graph
        self._optimize = optimize
        self._optimized: Optional[Tuple[Graph, Dict[NodeId, Prefix]]] = plan
        self._memo: Dict[GraphId, Expression] = {}
        self._structure_checked = False

    @property
    def graph(self) -> Graph:
        """The unoptimized graph (used for graph splicing)."""
        return self._raw_graph

    @property
    def optimized_graph(self) -> Graph:
        return self._optimized_plan()[0]

    def _optimized_plan(self) -> Tuple[Graph, Dict[NodeId, Prefix]]:
        if self._optimized is None:
            if self._optimize:
                optimizer = PipelineEnv.get().get_optimizer()
                self._optimized = optimizer.execute(self._raw_graph)
            else:
                self._optimized = (self._raw_graph, {})
        return self._optimized

    def _check_structure(self, graph: Graph) -> None:
        """The structural check, once per executor, before the first
        force; errors raise `PipelineValidationError` (a ValueError).
        Marked done only on success, so a retry fails the same way."""
        if self._structure_checked:
            return
        from ..analysis import structural_report

        structural_report(graph).raise_for_errors()
        self._structure_checked = True

    def execute(self, graph_id: GraphId) -> Expression:
        """Execute up to ``graph_id``, returning its lazy Expression
        (GraphExecutor.scala:53-80)."""
        graph, prefixes = self._optimized_plan()
        self._check_structure(graph)
        return self._force(graph_id, graph, prefixes, PipelineEnv.get())

    def _force(self, vid: GraphId, graph: Graph,
               prefixes: Dict[NodeId, Prefix], env: PipelineEnv) -> Expression:
        """``vid``'s expression, memoized. A method, not a nested
        function: a recursive closure would hold this executor, and its
        memo's tensors, in a reference cycle after the call."""
        if vid in self._memo:
            return self._memo[vid]
        if isinstance(vid, SourceId):
            raise ValueError(f"{vid} is an unbound source; bind data by "
                             "applying the pipeline")
        if isinstance(vid, SinkId):
            expr = self._force(graph.get_sink_dependency(vid), graph,
                               prefixes, env)
        else:
            dep_exprs = [self._force(d, graph, prefixes, env)
                         for d in graph.get_dependencies(vid)]
            op = graph.get_operator(vid)
            expr = op.execute(dep_exprs)
            if env.profiler is not None:
                expr = _profiled(op.label, vid.id, expr, env.profiler)
            prefix = prefixes.get(vid)
            if prefix is not None and prefix not in env.state:
                env.state[prefix] = expr
        self._memo[vid] = expr
        return expr
