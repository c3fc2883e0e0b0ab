"""Lazy memoized graph execution, with a concurrent scheduler and
warm-ups.

Counterpart of `keystone_tpu/workflow/executor.py` (reference
workflow/GraphExecutor.scala:14-81): executing a graph up to a `GraphId`
optimizes the graph once (lazily, with the process-wide optimizer), runs
the structural check, then evaluates dependencies with one memo entry
per vertex. Results of nodes whose prefixes the optimizer marked
saveable go into `PipelineEnv.state`, so later executors reuse them: an
estimator is fit once (GraphExecutor.scala:65-71).

The concurrent scheduler (`:203-232, 722-930`; `ExecutionConfig.
concurrent_dispatch`, ``dispatch_workers``): forcing a root first forces
its ancestors on a bounded worker pool in topological order, so
independent subgraphs (gather branches, train and test applies, fits)
run at once. Each vertex is forced once, by one worker, after its
dependencies; a single-consumer stream stays lazy in its consumer; on a
failure the pool stops taking work and the failure of the earliest
vertex in topological order is raised, the one a serial force meets
first. `execute_stream` (`:930-940`) yields the root's chunks.

Warm-ups (`:71-160, 449-608`; ``aot_warmup``): at execute time a daemon
thread readies the plan's fused chains whose input is a bound dataset on
the card (the shapes read from its tensor), counting no launch. A chain
that is itself an operator of the graph (a fitted or loaded pipeline's,
kept to be applied again) is warmed fully
(`FusedBatchTransformer.warmup`): its launch plans built by one eager
run and, for a megafused chain, its rung's graph captured, so that the
first apply replays. A chain whose fits resolve during the run (chains
whose fits resolve later are re-armed then) is warmed as far as its
next call needs: launch plans and kernels by one eager run on a zero
row. Its rung's graph is not captured: the first call at a rung runs
eagerly (`FusedBatchTransformer.run_rung`), so a pipeline applied once
pays no capture. A warm-up that fails breaks nothing:
``dispatch.warmup_failures`` counts it, and the force meets the same
error. With a serving envelope armed (``KEYSTONE_SLO_MS``), a chain
over a bound dataset is warmed at every rung of the envelope's pad
ladder too (`_serving_warm_counts`, `:160-182`).

Serving (`:111-128, 610-672`): `GraphExecutor.warm_manifest` takes the
certifier's `analysis.serving.warmup_manifest()` enumeration and warms
each fused program site at every ladder count it lists (on the card, a
megafused chain's graph captured at each rung); `warm_fitted_manifest`
does it for a fitted pipeline, which the serving runtime does before
its first request.

Under a tracer, the first execute embeds the static estimates in the
trace's metadata (`_record_static_estimates`, `:301-445`): the memory
pass's per-node bytes (``static_memory``), the roofline's per-stage
seconds (``roofline``) and, with an envelope armed, the serving
certificate (``serving``), from which it arms the conformance watchdog
(`telemetry/watchdog.py::maybe_arm_from_certificate`). The JAX
package's per-device sharding columns wait for the sharding tier.

While a tracer or a profiler is installed (`telemetry.trace_run`,
`utils/profiling.py::profile_execution`, which `autocache.profile_nodes`
uses), each node's force goes through the shared instrumentation
(`telemetry/instrument.py::instrument_node_force`, JAX's `:682-713`):
a ``node`` span, ``executor.node_forces``, the profiler's reading (closed
by a device sync only for a profiler), and ``executor.memo_hits`` and
``executor.prefix_saves``. The scheduler counts
``dispatch.scheduler_runs`` and ``dispatch.scheduled_tasks`` and runs
under a ``dispatch.schedule`` span (`:910-913`).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..telemetry.instrument import instrument_node_force
from ..telemetry.metrics import counter
from ..telemetry.spans import current_tracer, span
from .env import PipelineEnv, Prefix, execution_config
from .expressions import Expression, StreamingDatasetExpression
from .graph import Graph, GraphId, NodeId, SinkId, SourceId

logger = logging.getLogger(__name__)

_MEMO_HITS = counter("executor.memo_hits")
_PREFIX_SAVES = counter("executor.prefix_saves")
_SCHEDULER_RUNS = counter("dispatch.scheduler_runs")
_SCHEDULED_TASKS = counter("dispatch.scheduled_tasks")
_WARMUP_FAILURES = counter("dispatch.warmup_failures")

#: a pool worker re-entering `execute` runs its schedule serially
_sched_local = threading.local()

#: live warm-up threads, so measurements can wait for them
_warm_threads: List[threading.Thread] = []
_warm_threads_lock = threading.Lock()


def _spawn_warm_thread(target, name: str) -> None:
    t = threading.Thread(target=target, name=name, daemon=True)
    with _warm_threads_lock:
        _warm_threads[:] = [x for x in _warm_threads if x.is_alive()]
        _warm_threads.append(t)
    t.start()


def drain_warmups(timeout: float = 60.0) -> None:
    """Join every live warm-up thread, for at most ``timeout`` seconds
    in all."""
    deadline = time.monotonic() + timeout
    while True:
        with _warm_threads_lock:
            live = [t for t in _warm_threads if t.is_alive()]
            _warm_threads[:] = live
        if not live or time.monotonic() >= deadline:
            return
        for t in live:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


def _warmable(dataset) -> bool:
    """A bound dataset that puts a plan on the card: a device `Dataset`
    there, with rows."""
    data = getattr(dataset, "data", None)
    return (isinstance(data, torch.Tensor) and data.device.type == "cuda"
            and getattr(dataset, "count", 0) > 0)


class WarmInput(NamedTuple):
    """What a warm-up reads of a chain's input, from its propagated
    spec: the rows' item shape and dtype, the device, the row count."""

    item_shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    count: int


def _plan_device(graph: Graph) -> Optional[torch.device]:
    """The card a plan's bound datasets live on (`_warmable`), else None:
    warm-ups run on the card only."""
    from .operators import DatasetOperator

    for vid in sorted(graph.operators, key=lambda n: n.id):
        op = graph.get_operator(vid)
        if isinstance(op, DatasetOperator) and _warmable(op.dataset):
            return op.dataset.data.device
    return None


def _warm_input(spec, device) -> Optional[WarmInput]:
    """A chain input's `WarmInput` from its propagated spec, where that
    is a dataset on the device with a known one-array element and rows
    (JAX's ``data_spec``, `keystone_tpu/workflow/executor.py:541-547`)."""
    from ..analysis.specs import DataSpec, ShapeDtype

    if not (isinstance(spec, DataSpec) and spec.kind == "dataset"
            and spec.on_device and spec.count
            and isinstance(spec.element, ShapeDtype)):
        return None
    return WarmInput(tuple(spec.element.shape), spec.element.dtype, device,
                     int(spec.count))


def _submit_warmup(op, inp: WarmInput, full: bool = True,
                   counts: Tuple[int, ...] = ()) -> None:
    """Warm ``op`` (a fused transformer) for ``inp``'s rows on a daemon
    thread, unless it is warm for them already: fully (its `warmup`: a
    megafused chain's graph captured), or, where not ``full``, by the
    plain chain's warm-up (one eager run on a zero row). ``counts`` adds
    row counts to warm fully (a serving envelope's ladder). A failure is
    counted in ``dispatch.warmup_failures`` and logged."""
    _submit_counts(op, inp.item_shape, inp.dtype, inp.device, (inp.count,),
                   full)
    if counts:
        _submit_counts(op, inp.item_shape, inp.dtype, inp.device, counts,
                       True)


def _submit_counts(op, item_shape, dtype, device, counts, full: bool = True,
                   thread: bool = True) -> None:
    """Warm ``op`` for rows of ``item_shape`` at each of ``counts``, the
    counts one after another on one daemon thread (or on this thread),
    skipping those it is warm for."""
    from ..nodes.util.fusion import FusedBatchTransformer

    if full:
        is_warm, warmup = op.is_warm, op.warmup
    else:
        is_warm = functools.partial(FusedBatchTransformer.is_warm, op)
        warmup = functools.partial(FusedBatchTransformer.warmup, op)
    todo = [c for c in dict.fromkeys(int(c) for c in counts if c)
            if not is_warm(item_shape, dtype, c, device)]
    if not todo:
        return

    def run():
        for count in todo:
            try:
                warmup(item_shape, dtype, count, device)
            except Exception as e:
                _WARMUP_FAILURES.inc()
                logger.debug("warm-up of %s at %d rows failed: %s: %s",
                             op.label, count, type(e).__name__, e)

    if thread:
        _spawn_warm_thread(run, "keystone-warmup")
    else:
        run()


def _serving_warm_counts() -> List[int]:
    """The extra warm counts a declared serving envelope demands: every
    pad-ladder rung `analysis.serving.ladder_shapes` enumerates, the
    counts `warmup_manifest` lists (`keystone_tpu/workflow/executor.py:
    160-182`). Empty when no envelope is armed; a certifier fault never
    breaks a warm-up."""
    try:
        from ..analysis.serving import envelope_from_env, ladder_shapes

        envelope = envelope_from_env()
        if envelope is None:
            return []
        return ladder_shapes(envelope)
    except Exception:
        return []


def warm_fitted_manifest(fitted, manifest, sample, device=None) -> int:
    """Warm a fitted pipeline before traffic (`:610-634`): ``sample`` (a
    host batch of the ingress element, or a dataset) bound into an
    executor over the fitted apply graph, which takes ``manifest`` (an
    `analysis.serving.warmup_manifest()` enumeration) to
    `GraphExecutor.warm_manifest`. The graphs captured and plans built
    are the fitted transformers' own, so every later
    `FittedPipeline.apply` replays them. ``device``: where the sample
    goes (default the card). The warm-up runs on the calling thread.
    Returns the program sites warmed."""
    from ..data.dataset import Dataset
    from .operators import DatasetOperator

    data = (sample if getattr(sample, "is_dataset", False)
            else Dataset(sample, device=device))
    g, nid = fitted.graph.add_node(DatasetOperator(data), [])
    g = g.replace_dependency(fitted.source, nid).remove_source(fitted.source)
    return GraphExecutor(g, optimize=False).warm_manifest(manifest,
                                                          data.device)


def _sequential(tasks: List[GraphId], eff_deps) -> bool:
    """Whether each task (in topological order) depends, directly or
    not, on the one before it, so that a pool could run none of them at
    once. The JAX package starts its pool regardless; on the card a
    pool's threads cost more than a short serial force."""
    before: Dict[GraphId, set] = {}
    for v in tasks:
        anc: set = set()
        for d in eff_deps[v]:
            anc.add(d)
            anc |= before[d]
        before[v] = anc
    return all(tasks[i - 1] in before[tasks[i]]
               for i in range(1, len(tasks)))


def concurrent_relation(graph: Graph):
    """``unordered(u, v)``: whether the concurrent scheduler could force
    ``u`` and ``v`` at once, that is, neither is an ancestor of the other
    (`keystone_tpu/workflow/executor.py:203-232`)."""
    from .analysis import ancestors

    anc: Dict[GraphId, frozenset] = {}

    def _anc(v: GraphId) -> frozenset:
        got = anc.get(v)
        if got is None:
            got = anc[v] = frozenset(ancestors(graph, v))
        return got

    def unordered(u: GraphId, v: GraphId) -> bool:
        return u != v and u not in _anc(v) and v not in _anc(u)

    return unordered


def _spec_dtype_name(spec) -> Optional[str]:
    """The boundary dtype of a propagated `DataSpec` ("float32", "uint8";
    mixed pytrees joined with "+"), or None where unknown (`:185-200`):
    the reconcile table's dtype column, by the formatter of
    ``--explain-precision``."""
    from ..analysis.precision import _elem_dtype_name
    from ..analysis.specs import DataSpec, is_known

    if not isinstance(spec, DataSpec) or not is_known(spec.element):
        return None
    name = _elem_dtype_name(spec)
    return None if name == "?" else name


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
        self._warmed = False
        self._concurrent_wrapped: set = set()
        # fused chains whose fits had not resolved at the warm scan:
        # re-armed once they have (`_rearm_warmup`)
        self._warm_pending: List[tuple] = []
        self._warm_est_watch: set = set()
        self._warm_lock = threading.Lock()
        self._static_recorded = False

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

    def _warm_plan(self, graph: Graph) -> None:
        """Warm the plan's fused chains once per executor (`:449-572`):
        those whose input the propagated specs (`analysis.propagate.
        spec_pass`) show as a dataset on the card, whatever stage made
        it, and those whose fits resolved (saved state); chains whose fits
        have not run yet are parked until they have. A failure of the
        scan is counted and never breaks execution."""
        if self._warmed:
            return
        self._warmed = True
        if not execution_config().aot_warmup:
            return
        from ..analysis.propagate import spec_pass
        from ..nodes.util.fusion import FusedBatchTransformer
        from .fusion_rule import FusedChainOperator
        from .operators import ExpressionOperator

        targets = []
        for vid in sorted(graph.operators, key=lambda n: n.id):
            op = graph.get_operator(vid)
            deps = graph.get_dependencies(vid)
            if isinstance(op, FusedBatchTransformer) and len(deps) == 1:
                targets.append((op, (), deps[0]))
            elif isinstance(op, FusedChainOperator) and deps:
                targets.append((op, tuple(deps[:-1]), deps[-1]))
        device = _plan_device(graph) if targets else None
        if device is None:
            return
        try:
            specs, _ = spec_pass(graph, {})
        except Exception as e:  # a warm-up never breaks a run
            _WARMUP_FAILURES.inc()
            logger.debug("warm-up scan failed: %s: %s", type(e).__name__, e)
            return
        serving_counts = tuple(_serving_warm_counts())
        for op, est_deps, data_dep in targets:
            inp = _warm_input(specs.get(data_dep), device)
            if inp is None:
                continue
            if isinstance(op, FusedBatchTransformer):
                _submit_warmup(op, inp, counts=serving_counts)
                continue
            fitted = []
            for dep in est_deps:
                eop = (graph.get_operator(dep)
                       if isinstance(dep, NodeId) else None)
                if not (isinstance(eop, ExpressionOperator)
                        and eop.expression.is_forced):
                    fitted = None
                    break
                fitted.append(eop.expression.get)
            if fitted is None:
                with self._warm_lock:
                    self._warm_pending.append((op, est_deps, inp))
                    self._warm_est_watch.update(est_deps)
                continue
            self._warm_materialized(op, fitted, inp)

    @staticmethod
    def _warm_materialized(op, fitted, inp: WarmInput) -> None:
        from ..nodes.util.fusion import FusedBatchTransformer

        try:
            mat = op.materialize(fitted)
        except Exception:
            _WARMUP_FAILURES.inc()
            return
        if isinstance(mat, FusedBatchTransformer):
            _submit_warmup(mat, inp, full=False)

    def _rearm_warmup(self) -> None:
        """Warm the parked chains whose fits have all resolved since."""
        if not self._warm_pending or not execution_config().aot_warmup:
            return
        from .expressions import TransformerExpression

        with self._warm_lock:
            pending, self._warm_pending = self._warm_pending, []
        still = []
        for op, est_deps, inp in pending:
            exprs = [self._memo.get(d) for d in est_deps]
            if all(isinstance(e, TransformerExpression) and e.is_forced
                   for e in exprs):
                self._warm_materialized(op, [e.get for e in exprs], inp)
            else:
                still.append((op, est_deps, inp))
        if still:
            with self._warm_lock:
                self._warm_pending.extend(still)

    def warm_manifest(self, manifest, device) -> int:
        """Warm each site of a `warmup_manifest()` enumeration at every
        count it lists, on the calling thread (`:636-672`, where JAX
        submits to warm-up threads): the entry resolved against this
        executor's plan by vertex id, else by label; a fused chain over
        estimator fits materialized from its forced fits. Returns the
        sites warmed; never raises (a failure counts in
        ``dispatch.warmup_failures``)."""
        graph, _ = self._optimized_plan()
        from ..analysis.specs import ShapeDtype
        from ..nodes.util.fusion import FusedBatchTransformer
        from .expressions import TransformerExpression
        from .fusion_rule import FusedChainOperator
        from .operators import ExpressionOperator

        def resolve(entry):
            by_label = None
            for vid in graph.operators:
                op = graph.get_operator(vid)
                if not isinstance(op, (FusedBatchTransformer,
                                       FusedChainOperator)):
                    continue
                if vid.id == entry.get("vertex"):
                    return vid, op
                if by_label is None and op.label == entry.get("label"):
                    by_label = (vid, op)
            return by_label

        warmed = 0
        for entry in manifest or ():
            try:
                hit = resolve(entry)
                elem = entry.get("element")
                if hit is None or not isinstance(elem, ShapeDtype):
                    continue
                vid, op = hit
                if isinstance(op, FusedChainOperator):
                    fitted = []
                    for dep in graph.get_dependencies(vid)[:-1]:
                        eop = (graph.get_operator(dep)
                               if isinstance(dep, NodeId) else None)
                        expr = (eop.expression
                                if isinstance(eop, ExpressionOperator)
                                else self._memo.get(dep))
                        if not (isinstance(expr, TransformerExpression)
                                and expr.is_forced):
                            fitted = None
                            break
                        fitted.append(expr.get)
                    if fitted is None:
                        continue
                    op = op.materialize(fitted)
                    if not isinstance(op, FusedBatchTransformer):
                        continue
                _submit_counts(op, tuple(elem.shape), elem.dtype,
                               torch.device(device), entry["counts"],
                               thread=False)
                warmed += 1
            except Exception:
                _WARMUP_FAILURES.inc()
                continue
        return warmed

    def _record_static_estimates(self, graph: Graph, tracer) -> None:
        """Embed the static estimates in the trace's metadata, once an
        executor and only under a tracer (`:301-445`): the memory pass's
        per-node bytes and peak (``static_memory``), the roofline's
        per-stage FLOPs, bytes and seconds (``roofline``) and, with an
        envelope armed (``KEYSTONE_SLO_MS``), the serving certificate
        (``serving``), which also arms the conformance watchdog. Each
        node's entry carries its propagated partition spec and one
        card's bytes of it (`analysis/sharding.py` on the current mesh),
        the static side of a rank's observed bytes, and the metadata the
        per-device peak (`:315-378`). The graph is bound, so no source
        spec is needed. Never fails a run."""
        if self._static_recorded:
            return
        self._static_recorded = True
        try:
            from ..analysis.memory import memory_pass
            from ..analysis.propagate import spec_pass
            from ..analysis.sharding import (
                per_device_bytes,
                per_device_pass,
                sharding_pass,
                spec_str,
            )
            from ..parallel.mesh import layout_of

            specs, _ = spec_pass(graph, {})
            est, _ = memory_pass(graph, specs)
            mesh = layout_of(None)
            try:
                shardings, _, _ = sharding_pass(graph, specs, mesh=mesh)
                per_device_pass(graph, specs, shardings, est, mesh=mesh)
            except Exception:  # the byte estimates below must still land
                shardings = {}
            meta = tracer.metadata.setdefault(
                "static_memory", {"per_node": {}, "peak_bytes": 0,
                                  "per_device_peak_bytes": 0})
            for vid, nbytes in est.per_node.items():
                if nbytes is None:
                    continue
                label = graph.get_operator(vid).label
                key = f"{vid.id}:{label}"
                prev = meta["per_node"].get(key)
                # train and test applies collide on id:label: keep the
                # larger estimate
                if prev is None or prev["bytes"] < int(nbytes):
                    entry = {"label": label, "vertex": vid.id,
                             "bytes": int(nbytes)}
                    dt = _spec_dtype_name(specs.get(vid))
                    if dt is not None:
                        # the propagated boundary dtype (`:360-365`):
                        # uint8 loaders and planned bf16 boundaries show
                        # in the reconcile table
                        entry["dtype"] = dt
                    sv = shardings.get(vid)
                    if sv is not None:
                        entry["spec"] = spec_str(sv)
                        pd = per_device_bytes(specs.get(vid), sv, mesh)
                        if pd is not None:
                            entry["per_device_bytes"] = int(pd)
                    meta["per_node"][key] = entry
            meta["peak_bytes"] = max(meta["peak_bytes"], int(est.peak_bytes))
            meta["per_device_peak_bytes"] = max(
                meta.get("per_device_peak_bytes", 0),
                int(est.per_device_peak_bytes or 0))
            roof = None
            try:
                from ..analysis.roofline import roofline_pass

                roof, _ = roofline_pass(graph, specs)
                rmeta = tracer.metadata.setdefault(
                    "roofline", {"per_node": {}, "plan_predicted_seconds": 0.0,
                                 "peak_flops": roof.machine.peak_flops,
                                 "peak_bw": roof.machine.peak_bw})
                for vid, st in roof.stages.items():
                    key = f"{vid.id}:{st.label}"
                    prev = rmeta["per_node"].get(key)
                    if prev is None or prev["predicted_seconds"] \
                            < st.predicted_seconds:
                        rmeta["per_node"][key] = {
                            "label": st.label, "vertex": vid.id,
                            "flops": float(st.flops),
                            "hbm_bytes": int(st.hbm_bytes),
                            "intensity": float(st.intensity),
                            "bound": st.bound,
                            "predicted_seconds": float(st.predicted_seconds),
                        }
                rmeta["plan_predicted_seconds"] = max(
                    rmeta["plan_predicted_seconds"], float(roof.plan_seconds))
            except Exception:
                pass  # the byte estimates above must still land
            try:
                from ..analysis.serving import envelope_from_env, serving_pass
                from ..telemetry.watchdog import maybe_arm_from_certificate

                envelope = envelope_from_env()
                if envelope is not None:
                    cert, _ = serving_pass(graph, specs, envelope, memory=est,
                                           roofline=roof, record=False)
                    record = cert.as_record()
                    # a later executor (the apply after the fit) wins
                    tracer.metadata["serving"] = record
                    maybe_arm_from_certificate(
                        record, pipeline=cert.dominating_stage or "pipeline")
            except Exception:
                pass
        except Exception:  # estimation never breaks execution
            pass

    def execute(self, graph_id: GraphId) -> Expression:
        """Execute up to ``graph_id``, returning its lazy Expression
        (GraphExecutor.scala:53-80)."""
        graph, prefixes = self._optimized_plan()
        self._check_structure(graph)
        tracer = current_tracer()
        if tracer is not None:
            self._record_static_estimates(graph, tracer)
        self._warm_plan(graph)
        self._rearm_warmup()  # fits may have resolved since the scan
        env = PipelineEnv.get()
        observing = env.profiler is not None or current_tracer() is not None
        root = self._force(graph_id, graph, prefixes, env, observing)
        self._arm_concurrent(graph_id, root, graph)
        return root

    def execute_stream(self, graph_id: GraphId):
        """``(indices, payload)`` chunks of ``graph_id``'s value as its
        last stage drains; one ``(None, value)`` chunk where it does not
        stream."""
        expr = self.execute(graph_id)
        if isinstance(expr, StreamingDatasetExpression):
            yield from expr.iter_chunks()
        else:
            yield None, expr.get

    # ---------------------------------------------------- concurrent force

    def _arm_concurrent(self, root_id: GraphId, root: Expression,
                        graph: Graph) -> None:
        """Hook the scheduler into ``root``'s force (or its first chunk
        drain): nothing runs before the caller forces, and the on/off
        choice is read from the config at force time."""
        if root_id in self._concurrent_wrapped or root.is_forced:
            return
        self._concurrent_wrapped.add(root_id)

        def prefetch():
            if getattr(_sched_local, "active", False):
                return  # a pool worker: its schedule already ordered this
            cfg = execution_config()
            if cfg.concurrent_dispatch and cfg.dispatch_workers > 1:
                self._force_concurrent(root_id, graph, cfg.dispatch_workers)

        chunks_thunk = getattr(root, "_chunks_thunk", None)
        if chunks_thunk is not None:
            def chunks(orig=chunks_thunk):
                prefetch()
                return orig()

            root._chunks_thunk = chunks
        elif root._thunk is not None:
            def thunk(orig=root._thunk):
                prefetch()
                return orig()

            root._thunk = thunk

    def _schedule_plan(self, root_id: GraphId, graph: Graph):
        """``(tasks, eff_deps)``: the topologically ordered vertices the
        pool forces and, for each, the tasks that must finish first. A
        vertex is deferred into its consumer's task when it is forced
        already, when it is the root, or when it is a stream that may
        carry several chunks and has one consumer (its chunks must flow
        lazily into that consumer)."""
        from .analysis import linearize
        from .operators import is_stream_origin

        order = [v for v in linearize(graph, root_id)
                 if not isinstance(v, SourceId)]
        scope = set(order)

        def vertex_deps(v) -> List[GraphId]:
            if isinstance(v, SinkId):
                deps = [graph.get_sink_dependency(v)]
            else:
                deps = list(graph.get_dependencies(v))
            return [d for d in dict.fromkeys(deps) if d in scope]

        users: Dict[GraphId, int] = {}
        for v in order:
            for d in vertex_deps(v):
                users[d] = users.get(d, 0) + 1
        may_stream: Dict[GraphId, bool] = {}
        for v in order:
            if isinstance(v, SinkId):
                may_stream[v] = any(may_stream.get(d, False)
                                    for d in vertex_deps(v))
                continue
            op = graph.get_operator(v)
            cap = getattr(op, "may_consume_chunks",
                          getattr(op, "chunkable", False))
            may_stream[v] = is_stream_origin(op) or (
                bool(cap) and any(may_stream.get(d, False)
                                  for d in vertex_deps(v)))
        deferred = set()
        root_expr = self._memo.get(root_id)
        for v in order:
            expr = self._memo.get(v)
            if expr is None or expr.is_forced:
                deferred.add(v)
            elif v == root_id or expr is root_expr:
                deferred.add(v)
            elif (isinstance(expr, StreamingDatasetExpression)
                  and users.get(v, 0) <= 1 and may_stream.get(v, False)):
                deferred.add(v)
        # in topological order, so a deferred dependency's set is ready;
        # a loop, not a recursive closure, whose reference cycle would
        # keep the graph's tensors alive until a garbage collection
        eff: Dict[GraphId, frozenset] = {}
        for v in order:
            out = set()
            for d in vertex_deps(v):
                if d in deferred:
                    out |= eff[d]
                else:
                    out.add(d)
            eff[v] = frozenset(out)

        tasks = [v for v in order if v not in deferred]
        return tasks, {v: eff[v] for v in tasks}

    def _force_concurrent(self, root_id: GraphId, graph: Graph,
                          workers: int) -> None:
        """Force the root's ancestor tasks on a pool of ``workers``
        threads in topological order; raise the earliest failure."""
        tasks, eff_deps = self._schedule_plan(root_id, graph)
        if len(tasks) < 2 or _sequential(tasks, eff_deps):
            return  # no two tasks could run at once: the force is serial
        topo_index = {v: i for i, v in enumerate(tasks)}
        indeg = {v: len(eff_deps[v]) for v in tasks}
        dependents: Dict[GraphId, List[GraphId]] = {v: [] for v in tasks}
        for v in tasks:
            for d in eff_deps[v]:
                dependents[d].append(v)
        cond = threading.Condition()
        ready = sorted((v for v in tasks if indeg[v] == 0),
                       key=topo_index.__getitem__)
        outstanding = len(tasks)
        failures: List[Tuple[int, BaseException]] = []
        stop = False

        def worker():
            nonlocal outstanding, stop
            _sched_local.active = True
            try:
                while True:
                    with cond:
                        while not ready and outstanding and not stop:
                            cond.wait()
                        if not ready or stop:
                            return
                        v = ready.pop(0)
                    err = None
                    try:
                        self._memo[v].get
                    except BaseException as e:  # raised in order below
                        err = e
                    if err is None and v in self._warm_est_watch:
                        self._rearm_warmup()
                    with cond:
                        outstanding -= 1
                        if err is not None:
                            failures.append((topo_index[v], err))
                            stop = True
                        else:
                            for u in dependents[v]:
                                indeg[u] -= 1
                                if indeg[u] == 0:
                                    ready.append(u)
                            ready.sort(key=topo_index.__getitem__)
                        cond.notify_all()
            finally:
                _sched_local.active = False

        _SCHEDULER_RUNS.inc()
        _SCHEDULED_TASKS.inc(len(tasks))
        n = min(workers, len(tasks))
        with span("dispatch.schedule", cat="phase", tasks=len(tasks),
                  workers=n):
            threads = [threading.Thread(target=worker,
                                        name=f"keystone-dispatch-{i}",
                                        daemon=True) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if failures:
            raise min(failures, key=lambda f: f[0])[1]

    def _force(self, vid: GraphId, graph: Graph,
               prefixes: Dict[NodeId, Prefix], env: PipelineEnv,
               observing: bool) -> Expression:
        """``vid``'s expression, memoized; where ``observing`` (a tracer
        or a profiler), instrumented and counted. A method, not a nested
        function: a recursive closure would hold this executor, and its
        memo's tensors, in a reference cycle after the call."""
        if vid in self._memo:
            if observing:
                _MEMO_HITS.inc()
            return self._memo[vid]
        if isinstance(vid, SourceId):
            raise ValueError(f"{vid} is an unbound source; bind data by "
                             "applying the pipeline")
        if isinstance(vid, SinkId):
            expr = self._force(graph.get_sink_dependency(vid), graph,
                               prefixes, env, observing)
        else:
            dep_exprs = [self._force(d, graph, prefixes, env, observing)
                         for d in graph.get_dependencies(vid)]
            op = graph.get_operator(vid)
            expr = op.execute(dep_exprs)
            if observing:
                expr = instrument_node_force(op.label, expr, vertex=vid.id,
                                             profiler=env.profiler)
            prefix = prefixes.get(vid)
            if prefix is not None and prefix not in env.state:
                env.state[prefix] = expr
                if observing:
                    _PREFIX_SAVES.inc()
        self._memo[vid] = expr
        return expr
