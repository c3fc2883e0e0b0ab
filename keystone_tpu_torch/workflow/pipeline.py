"""Typed combinator API: Transformer / Estimator / Pipeline.

Counterpart of `keystone_tpu/workflow/pipeline.py:42-734` (reference
workflow/{Pipeline,Chainable,Transformer,Estimator,LabelEstimator,
FittedPipeline,PipelineResult,ChainUtils,OptimizableNodes}.scala).
Typed combinators (`and_then`, `>>`, `gather`, `with_data`) build the
untyped operator `Graph`; execution is lazy and memoized through
`GraphExecutor`:
  - **Laziness**: applying a pipeline returns a `PipelineDataset` or
    `PipelineDatum` handle; nothing runs until `.get()`
    (PipelineResult.scala:13-21).
  - **Fit-once**: estimator fits are memoized process-wide by structural
    prefix, so re-applying or extending a pipeline never refits
    (PipelineSuite.scala:28-52).
  - **Single/batch duality**: one graph serves a datum or a dataset
    (Operator.scala:77-100).

A `Transformer` here maps a batch of rows with `batch_fn` (the port's
batch idiom; its `batch_transform` is `apply_batch`, which maps
`batch_fn` over a dataset's rows); `ItemTransformer` maps `apply` over a
`HostDataset`'s items, as JAX's `Transformer.apply_batch` does over a
host dataset (`:497-521`). `FittedPipeline.save` writes a plain pickle
whose tensors are CPU tensors; `load` places them on the device asked
for.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..telemetry.watchdog import request_scope
from .env import PipelineEnv
from .executor import GraphExecutor
from .graph import Graph, NodeId, NodeOrSourceId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    GatherTransformerOperator,
    TransformerOperator,
)


# --------------------------------------------------------------------------
# Results


class PipelineResult:
    """Lazy handle on (executor, sink); `.get()` triggers execution
    (PipelineResult.scala:13-21)."""

    def __init__(self, executor: GraphExecutor, sink: SinkId):
        self.executor = executor
        self.sink = sink

    @property
    def graph(self) -> Graph:
        return self.executor.graph

    def get(self):
        return self.executor.execute(self.sink).get

    def stream(self):
        """The result chunk by chunk (`keystone_tpu/workflow/pipeline.py:
        57-64`): ``(indices, rows)`` as the last stage drains, or one
        ``(None, value)`` chunk where the pipeline does not stream.
        Drained chunks are memoized: after a full drain ``.get()`` is
        free, and after an early exit it resumes the remaining chunks
        without re-running the ones already seen."""
        return self.executor.execute_stream(self.sink)


class PipelineDataset(PipelineResult):
    """Lazy dataset result (PipelineDataset.scala:10-23)."""


class PipelineDatum(PipelineResult):
    """Lazy single-datum result (PipelineDatum.scala:8-21)."""


def _splice_result(g: Graph, result: PipelineResult) -> Tuple[Graph, NodeOrSourceId]:
    """Merge a lazy result's (unoptimized) graph into ``g`` and return the
    vertex producing its value, so an estimator trains on another
    pipeline's lazy output with full state sharing."""
    if result.graph.sources:
        raise ValueError("cannot splice a pipeline result with unbound sources")
    g2, _, kmap = g.add_graph(result.graph)
    vid = g2.get_sink_dependency(kmap[result.sink])
    for k in kmap.values():
        g2 = g2.remove_sink(k)
    return g2, vid


def _add_data_vertex(g: Graph, data: Any) -> Tuple[Graph, NodeOrSourceId]:
    """Bind a data argument: lazy results are spliced, anything else is
    wrapped in a DatasetOperator."""
    if isinstance(data, PipelineResult):
        return _splice_result(g, data)
    return g.add_node(DatasetOperator(data), [])


def _bind(graph: Graph, source: SourceId, data: Any) -> Tuple[Graph, type]:
    """``graph`` with ``source`` bound to ``data`` (a dataset: anything
    marked ``is_dataset``; else a datum), and the result class."""
    if getattr(data, "is_dataset", False):
        op, cls = DatasetOperator(data), PipelineDataset
    else:
        op, cls = DatumOperator(data), PipelineDatum
    g, nid = graph.add_node(op, [])
    return g.replace_dependency(source, nid).remove_source(source), cls


# --------------------------------------------------------------------------
# Chainable


class Chainable:
    """`and_then` combinators shared by Pipeline and Transformer
    (Chainable.scala:13-126)."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def and_then(self, nxt, *fit_args) -> "Pipeline":
        """Compose with a Transformer/Pipeline, or fit-and-append an
        (Label)Estimator::

          p.and_then(transformer)
          p.and_then(estimator, data)
          p.and_then(label_estimator, data, labels)

        (Chainable.scala:26-126). The estimator trains on this pipeline
        applied to ``data``; CSE and the prefix table share that
        featurization with the final pipeline's."""
        me = self.to_pipeline()
        if isinstance(nxt, Estimator) and len(fit_args) == 1:
            return me.and_then(nxt.with_data(me.apply(fit_args[0])))
        if isinstance(nxt, LabelEstimator) and len(fit_args) == 2:
            return me.and_then(
                nxt.with_data(me.apply(fit_args[0]), fit_args[1]))
        if fit_args:
            raise TypeError("and_then: unexpected fit arguments")
        other = nxt.to_pipeline()
        g, kmap = me.graph.connect_graph(
            other.graph, {other.source: me.graph.get_sink_dependency(me.sink)})
        g = g.remove_sink(me.sink)
        return Pipeline(g, me.source, kmap[other.sink])

    def __rshift__(self, nxt) -> "Pipeline":
        return self.and_then(nxt)


# --------------------------------------------------------------------------
# Pipeline


class Pipeline(Chainable):
    """Typed facade over (graph, source, sink) (Pipeline.scala:22-155)."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.graph = graph
        self.source = source
        self.sink = sink

    def to_pipeline(self) -> "Pipeline":
        return self

    def apply(self, data: Any) -> PipelineResult:
        """Bind data and return a lazy result: lazy results are
        graph-spliced; datasets (anything marked ``is_dataset``) take the
        batch path; anything else is one datum (Pipeline.scala:67-96)."""
        if isinstance(data, PipelineResult):
            g, smap, kmap = data.graph.add_graph(self.graph)
            tgt = data.graph.get_sink_dependency(data.sink)
            src = smap[self.source]
            g = g.replace_dependency(src, tgt).remove_source(src)
            cls = (PipelineDataset if isinstance(data, PipelineDataset)
                   else PipelineDatum)
            return cls(GraphExecutor(g), kmap[self.sink])
        g, cls = _bind(self.graph, self.source, data)
        return cls(GraphExecutor(g), self.sink)

    def __call__(self, data: Any) -> PipelineResult:
        return self.apply(data)

    def data_path(self) -> List[NodeId]:
        """The nodes from this pipeline's source to its sink along their
        data inputs (a delegate's is its second dependency), ending at a
        node with several data inputs such as a gather."""
        path: List[NodeId] = []
        vid = self.graph.get_sink_dependency(self.sink)
        while isinstance(vid, NodeId):
            path.append(vid)
            op = self.graph.get_operator(vid)
            deps = self.graph.get_dependencies(vid)
            if isinstance(op, DelegatingOperator):
                vid = deps[1]
            elif len(deps) == 1:
                vid = deps[0]
            else:
                break
        return path[::-1]

    def fitted(self, index: int = -1) -> TransformerOperator:
        """The transformer fitted by the ``index``-th estimator on this
        pipeline's data path (from its source; negative counts from its
        sink), fit now if it was not yet. The fit goes through the
        optimizer and the prefix table, so any later run that holds the
        same estimator on the same data reuses it."""
        ests = [self.graph.get_dependencies(n)[0] for n in self.data_path()
                if isinstance(self.graph.get_operator(n), DelegatingOperator)]
        if not ests:
            raise ValueError("this pipeline applies no estimator")
        # a sink keeps the estimator's vertex through CSE, which may merge
        # it into an equivalent node
        g, sink = self.graph.add_sink(ests[index])
        return GraphExecutor(g).execute(sink).get

    def fit(self) -> "FittedPipeline":
        """Fit every estimator now, put the fitted transformers in their
        place, prune the training branches and return a `FittedPipeline`
        that can be saved (Pipeline.scala:38-65)."""
        from .fusion_rule import FusedChainOperator
        from .optimizer import UnusedBranchRemovalRule

        plan = PipelineEnv.get().get_optimizer().execute(self.graph)
        g = plan[0]
        fit_exec = GraphExecutor(g, plan=plan)

        def fitted(est_dep):
            t = fit_exec.execute(est_dep).get  # forces the fit now
            if not isinstance(t, TransformerOperator):
                raise TypeError(f"estimator produced {type(t).__name__}, "
                                "expected a Transformer")
            return t

        for node in sorted(g.operators, key=lambda n: n.id):
            op = g.get_operator(node)
            deps = g.get_dependencies(node)
            if isinstance(op, DelegatingOperator):
                g = g.set_operator(node, fitted(deps[0]))
                g = g.set_dependencies(node, deps[1:])
            elif isinstance(op, FusedChainOperator):
                # a fused chain across estimator apply boundaries: bake
                # the fitted transformers in, keep only the data input
                g = g.set_operator(node, op.materialize(
                    [fitted(d) for d in deps[:-1]]))
                g = g.set_dependencies(node, deps[-1:])
        g, _ = UnusedBranchRemovalRule().apply((g, {}))
        return FittedPipeline(g, self.source, self.sink)

    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Merge N branches that consume the same input into one pipeline
        whose output is the list of branch outputs (Pipeline.scala:
        119-154); a dataset's branch outputs are zipped row by row."""
        g = Graph()
        g, source = g.add_source()
        outs: List[NodeOrSourceId] = []
        for b in branches:
            bp = b.to_pipeline()
            g, kmap = g.connect_graph(bp.graph, {bp.source: source})
            outs.append(g.get_sink_dependency(kmap[bp.sink]))
            g = g.remove_sink(kmap[bp.sink])
        g, gid = g.add_node(GatherTransformerOperator(), outs)
        g, sink = g.add_sink(gid)
        return Pipeline(g, source, sink)

    @staticmethod
    def identity() -> "Pipeline":
        g = Graph()
        g, source = g.add_source()
        g, sink = g.add_sink(source)
        return Pipeline(g, source, sink)


# --------------------------------------------------------------------------
# FittedPipeline


class FittedPipeline(Chainable):
    """A pipeline of transformers only, which can be saved
    (FittedPipeline.scala:18-48, TransformerGraph.scala:12-29). Applies
    without re-optimization."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        for op in graph.operators.values():
            if isinstance(op, (EstimatorOperator, DelegatingOperator)):
                raise ValueError(f"FittedPipeline may not contain {op.label}")
        self.graph = graph
        self.source = source
        self.sink = sink

    def to_pipeline(self) -> Pipeline:
        return Pipeline(self.graph, self.source, self.sink)

    def apply(self, data: Any):
        """The pipeline's output on ``data`` (a dataset or a datum), run
        now. Each apply is one live request
        (`telemetry/watchdog.py::request_scope`, JAX's `:353-370`): its
        padded shape, host seconds and the armed watchdog's check; a
        no-op with ``KEYSTONE_LIVE_TELEMETRY=0``."""
        batch = 1
        if getattr(data, "is_dataset", False):
            try:
                batch = len(data)
            except TypeError:
                pass
        with request_scope(batch, pipeline="fitted_pipeline"):
            g, cls = _bind(self.graph, self.source, data)
            return cls(GraphExecutor(g, optimize=False), self.sink).get()

    def __call__(self, data: Any):
        return self.apply(data)

    def save(self, path: str) -> None:
        """Write to ``path`` as one pickle (FittedPipeline.scala:10), every
        tensor as a CPU tensor. Raises TypeError, naming the operator and
        writing nothing, when a node cannot be pickled (a `from_function`
        lambda: the port has no cloudpickle)."""
        from ..utils.serialization import save_pytree_pickle

        save_pytree_pickle(self, path, parts=self.graph.operators.values())

    @staticmethod
    def load(path: str, device="cuda") -> "FittedPipeline":
        """Read a saved pipeline, its tensors placed on ``device`` (the
        card by default; without one this raises unless ``device`` is
        "cpu")."""
        from ..device import resolve_device
        from ..utils.serialization import load_pytree_pickle

        obj = load_pytree_pickle(path, resolve_device(device))
        if not isinstance(obj, FittedPipeline):
            raise TypeError(f"{path} does not contain a FittedPipeline")
        return obj


# --------------------------------------------------------------------------
# Transformer


class Transformer(TransformerOperator, Chainable):
    """A batched tensor function (Transformer.scala:18-70). Subclasses
    implement `batch_fn`, which maps a (n, ...) tensor of rows to a
    (n, ...) tensor, or override `apply` and `apply_batch`; `apply` runs
    `batch_fn` on one datum.

    Overlap-engine hooks (`keystone_tpu/workflow/pipeline.py:430-468`):
    ``chunkable = True`` declares that the batch path distributes over
    chunks of items, so the stage consumes an upstream chunk stream as
    it drains; `apply_batch_stream` (an iterator of ``(indices, rows)``
    chunks over a `HostDataset`, or None) makes the stage a stream
    producer."""

    chunkable = False

    def apply_batch_stream(self, data: Any):
        """A streaming batch path over a `HostDataset`, or None (the
        operator then yields one whole-value chunk)."""
        return None

    def batch_transform_stream(self, inputs: List[Any]):
        from ..data.dataset import HostDataset

        if isinstance(inputs[0], HostDataset):
            return self.apply_batch_stream(inputs[0])
        return None

    def batch_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        raise NotImplementedError

    def apply(self, x: Any) -> Any:
        return self.batch_fn()(torch.as_tensor(x)[None])[0]

    def apply_batch(self, data: Any) -> Any:
        return data.map_batches(self.batch_fn())

    def single_transform(self, inputs: List[Any]) -> Any:
        return self.apply(inputs[0])

    def batch_transform(self, inputs: List[Any]) -> Any:
        return self.apply_batch(inputs[0])

    def to_pipeline(self) -> Pipeline:
        g = Graph()
        g, source = g.add_source()
        g, nid = g.add_node(self, [source])
        g, sink = g.add_sink(nid)
        return Pipeline(g, source, sink)

    def __call__(self, data: Any) -> PipelineResult:
        """Lazy application through the pipeline machinery."""
        return self.to_pipeline().apply(data)

    @staticmethod
    def from_function(fn: Callable[[Any], Any], name: str = None) -> "Transformer":
        """Lift a per-item function into a Transformer node
        (Transformer.scala:58-70)."""
        t = _FunctionTransformer(fn)
        if name:
            t._label = name
        return t


class _FunctionTransformer(Transformer):
    """``fn`` on each item: a host dataset's items, or a device
    dataset's rows stacked back."""

    chunkable = True  # per-item: distributes over chunks

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn
        self._label = None

    @property
    def label(self) -> str:
        return self._label or f"Fn[{getattr(self.fn, '__name__', 'lambda')}]"

    def apply(self, x: Any) -> Any:
        return self.fn(x)

    def apply_batch(self, data: Any) -> Any:
        if hasattr(data, "map"):
            return data.map(self.fn)
        return data.with_data(torch.stack([self.fn(x) for x in data.array]))


class ItemTransformer(Transformer):
    """A function of one host item (a string, a token list, a list of
    pairs). Its batch path maps `apply` over a `HostDataset`'s items."""

    def apply(self, x):
        raise NotImplementedError

    def apply_batch(self, data):
        return data.map(self.apply)


# --------------------------------------------------------------------------
# Estimators


class Estimator(EstimatorOperator, Chainable):
    """Unsupervised estimator: `fit(data) -> Transformer`
    (Estimator.scala:10-62)."""

    saveable = True  # fit results are memoized by prefix

    def fit(self, data: Any) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, inputs: List[Any]) -> TransformerOperator:
        return self.fit(inputs[0])

    def with_data(self, data: Any) -> Pipeline:
        """The fit-then-apply pipeline: the estimator node feeding a
        DelegatingOperator over a fresh source (Estimator.scala:18-46)."""
        g = Graph()
        g, data_id = _add_data_vertex(g, data)
        g, est_id = g.add_node(self, [data_id])
        g, source = g.add_source()
        g, delegate = g.add_node(DelegatingOperator(), [est_id, source])
        g, sink = g.add_sink(delegate)
        return Pipeline(g, source, sink)

    def to_pipeline(self):
        raise TypeError("an Estimator needs data: use .with_data(data)")


class LabelEstimator(EstimatorOperator, Chainable):
    """Supervised estimator: `fit(data, labels) -> Transformer`
    (LabelEstimator.scala:13-100)."""

    saveable = True

    def fit(self, data: Any, labels: Any) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, inputs: List[Any]) -> TransformerOperator:
        return self.fit(inputs[0], inputs[1])

    def with_data(self, data: Any, labels: Any) -> Pipeline:
        g = Graph()
        g, data_id = _add_data_vertex(g, data)
        g, labels_id = _add_data_vertex(g, labels)
        g, est_id = g.add_node(self, [data_id, labels_id])
        g, source = g.add_source()
        g, delegate = g.add_node(DelegatingOperator(), [est_id, source])
        g, sink = g.add_sink(delegate)
        return Pipeline(g, source, sink)

    def to_pipeline(self):
        raise TypeError(
            "a LabelEstimator needs data: use .with_data(data, labels)")


# --------------------------------------------------------------------------
# Chains (reference workflow/ChainUtils.scala:12-41)


class TransformerChain(Transformer):
    def __init__(self, stages: Sequence[Transformer]):
        self.stages = list(stages)

    @property
    def chunkable(self) -> bool:  # a chain distributes iff every stage does
        return all(getattr(s, "chunkable", False) for s in self.stages)

    @property
    def label(self) -> str:
        return " >> ".join(s.label for s in self.stages)

    def apply(self, x):
        for s in self.stages:
            x = s.apply(x)
        return x

    def apply_batch(self, data):
        for s in self.stages:
            data = s.apply_batch(data)
        return data


class EstimatorChain(Estimator):
    """prep >> estimator as one Estimator (ChainUtils.scala:12-24)."""

    def __init__(self, prep: Transformer, est: Estimator):
        self.prep = prep
        self.est = est

    @property
    def label(self) -> str:
        return f"{self.prep.label} >> {self.est.label}"

    def fit(self, data):
        return TransformerChain(
            [self.prep, self.est.fit(self.prep.apply_batch(data))])


class LabelEstimatorChain(LabelEstimator):
    """prep >> label estimator as one (ChainUtils.scala:26-41)."""

    def __init__(self, prep: Transformer, est: LabelEstimator):
        self.prep = prep
        self.est = est

    @property
    def label(self) -> str:
        return f"{self.prep.label} >> {self.est.label}"

    def fit(self, data, labels):
        return TransformerChain(
            [self.prep, self.est.fit(self.prep.apply_batch(data), labels)])


# --------------------------------------------------------------------------
# Optimizable nodes (reference workflow/OptimizableNodes.scala:12-50)


class OptimizableTransformer(Transformer):
    """A transformer with a default implementation and a sample-driven
    `optimize`, which `NodeOptimizationRule` consults."""

    @property
    def default(self) -> Transformer:
        raise NotImplementedError

    def optimize(self, sample: Any, num_per_shard: int) -> Transformer:
        raise NotImplementedError

    def apply(self, x):
        return self.default.apply(x)

    def apply_batch(self, data):
        return self.default.apply_batch(data)

    def optimize_from_sample(self, sample_inputs, scale):
        return self.optimize(sample_inputs[0], scale)


class OptimizableEstimator(Estimator):
    """An estimator with a default implementation and a sample-driven
    `optimize`, which `NodeOptimizationRule` consults
    (`keystone_tpu/workflow/pipeline.py:707-716`)."""

    @property
    def default(self) -> Estimator:
        raise NotImplementedError

    def optimize(self, sample: Any, num_per_shard: int) -> Estimator:
        raise NotImplementedError

    def fit(self, data):
        return self.default.fit(data)

    def optimize_from_sample(self, sample_inputs, scale):
        return self.optimize(sample_inputs[0], scale)


class OptimizableLabelEstimator(LabelEstimator):
    @property
    def default(self) -> LabelEstimator:
        raise NotImplementedError

    def optimize(self, sample: Any, sample_labels: Any,
                 num_per_shard: int) -> LabelEstimator:
        raise NotImplementedError

    def fit(self, data, labels):
        return self.default.fit(data, labels)

    def optimize_from_sample(self, sample_inputs, scale):
        return self.optimize(sample_inputs[0], sample_inputs[1], scale)
