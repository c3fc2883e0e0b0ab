"""Untyped execution units stored in graph nodes.

Counterpart of `keystone_tpu/workflow/operators.py:113-498` (reference
workflow/Operator.scala:10-176, GatherTransformerOperator.scala:9-18).
Each operator consumes a list of `Expression`s (one per dependency, in
order) and produces an `Expression`; everything stays lazy until a sink
is forced.

The dual batch/single dispatch (`batch_transform` against
`single_transform`, chosen by the dependency expressions' types,
Operator.scala:77-100) is kept: one pipeline graph serves a whole
dataset (anything marked ``is_dataset``: `Dataset`, `HostDataset`,
`SparseDataset`) and a single datum. With the overlap engine on
(`ExecutionConfig.overlap`), a one-input transformer or delegate returns
a `StreamingDatasetExpression` (`:27-60, 265-274, 419-427`): at force
time the stage consumes its input's chunks where it is ``chunkable``,
produces its own where it has a streaming batch path, and otherwise
yields its whole value as one chunk. The JAX package's static
``abstract_eval`` hooks (its analysis tiers) have no counterpart here
yet.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    StreamingDatasetExpression,
    TransformerExpression,
)


def _overlap_enabled() -> bool:
    from .env import execution_config

    return execution_config().overlap


def _chunk_payload(out, n: int):
    """A stage's result over one chunk of ``n`` items as a chunk
    payload: the rows of its single bucket, a dataset's rows, or the
    list of its items."""
    from ..data.dataset import HostDataset

    if isinstance(out, HostDataset):
        buckets = out._buckets
        if (buckets is not None and len(buckets) == 1
                and list(buckets[0][0]) == list(range(n))):
            return buckets[0][1]
        return list(out.items)
    if hasattr(out, "array") and getattr(out, "count", None) == n:
        return out.array[:n]
    return list(out)


def _chunk_items(transformer, payload) -> Any:
    """A chunkable transformer's batch path over one chunk's payload."""
    from ..data.dataset import HostDataset

    n = len(payload)
    if isinstance(payload, list):
        ds = HostDataset(payload)
    else:
        ds = HostDataset.from_buckets([(list(range(n)), payload)], n,
                                      device=payload.device)
    return _chunk_payload(transformer.batch_transform([ds]), n)


def is_stream_origin(op) -> bool:
    """Whether ``op`` produces a chunk stream itself (it overrides
    `Transformer.apply_batch_stream`), as opposed to passing chunks
    through (`keystone_tpu/analysis/hazards.py:127-133`)."""
    from .pipeline import Transformer

    fn = getattr(type(op), "apply_batch_stream", None)
    return fn is not None and fn is not Transformer.apply_batch_stream


def _streamed_batch(transformer, dep: Expression):
    """Chunks of one transformer stage over one dependency: the
    dependency's chunks mapped where it streams and the transformer is
    ``chunkable``; the transformer's own stream where it has one;
    else its batch result as one whole-value chunk."""
    if isinstance(dep, StreamingDatasetExpression) and getattr(
            transformer, "chunkable", False):
        for idxs, payload in dep.iter_chunks():
            if idxs is None:
                yield None, transformer.batch_transform([payload])
            else:
                yield idxs, _chunk_items(transformer, payload)
        return
    value = dep.get
    stream_fn = getattr(transformer, "batch_transform_stream", None)
    stream = stream_fn([value]) if stream_fn is not None else None
    if stream is None:
        yield None, transformer.batch_transform([value])
    else:
        yield from stream


class Operator:
    """Base class. Subclasses implement ``execute``."""

    @property
    def label(self) -> str:
        return type(self).__name__

    def execute(self, deps: Sequence[Expression]) -> Expression:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.label


class DatasetOperator(Operator):
    """Zero-dep operator wrapping an already-materialized dataset
    (Operator.scala:19-26)."""

    def __init__(self, dataset: Any, name: str = "dataset"):
        self.dataset = dataset
        self.name = name

    @property
    def label(self) -> str:
        return f"Dataset[{self.name}]"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        assert not deps
        return DatasetExpression.of(self.dataset)


class DatumOperator(Operator):
    """Zero-dep operator wrapping a single datum (Operator.scala:28-35)."""

    def __init__(self, datum: Any):
        self.datum = datum

    @property
    def label(self) -> str:
        return "Datum"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        assert not deps
        return DatumExpression.of(self.datum)


class TransformerOperator(Operator):
    """An operator with both per-item and bulk execution paths
    (Operator.scala:37-100).

    Subclasses (every `Transformer` node) implement ``single_transform``
    and ``batch_transform``. If any dependency is a `DatumExpression` the
    single-item path runs, else the batch path."""

    def single_transform(self, inputs: List[Any]) -> Any:
        raise NotImplementedError

    def batch_transform(self, inputs: List[Any]) -> Any:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        deps = list(deps)
        if not deps:
            raise ValueError("TransformerOperator requires data dependencies")
        n_datum = sum(isinstance(d, DatumExpression) for d in deps)
        if n_datum and n_datum != len(deps):
            raise ValueError(
                "TransformerOperator dependencies must be all datasets or "
                "all datums")
        if n_datum:
            return DatumExpression(
                lambda: self.single_transform([d.get for d in deps]))
        if len(deps) == 1 and _overlap_enabled():
            dep = deps[0]
            return StreamingDatasetExpression(
                lambda: _streamed_batch(self, dep))
        return DatasetExpression(
            lambda: self.batch_transform([d.get for d in deps]))


class EstimatorOperator(Operator):
    """Fits on datasets, lazily producing a TransformerOperator
    (Operator.scala:102-116)."""

    def fit_datasets(self, inputs: List[Any]) -> TransformerOperator:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        deps = list(deps)
        return TransformerExpression(
            lambda: self.fit_datasets([d.get for d in deps]))


class DelegatingOperator(Operator):
    """Applies the transformer produced by its first dependency to the rest
    (Operator.scala:136-163). Forcing the transformer expression is the
    moment an estimator's fit happens."""

    #: dependency indices that consume an estimator output (KP003
    #: fit-before-use exempts these; see `analysis.propagate`)
    estimator_positions: tuple = (0,)

    def execute(self, deps: Sequence[Expression]) -> Expression:
        deps = list(deps)
        if not deps:
            raise ValueError(
                "DelegatingOperator requires a transformer dependency")
        transformer_expr, data_deps = deps[0], deps[1:]
        if not isinstance(transformer_expr, TransformerExpression):
            raise ValueError(
                "DelegatingOperator's first dependency must be a transformer")
        if not data_deps:
            raise ValueError("DelegatingOperator requires data dependencies")
        n_datum = sum(isinstance(d, DatumExpression) for d in data_deps)
        if n_datum and n_datum != len(data_deps):
            raise ValueError(
                "DelegatingOperator data dependencies must be all datasets "
                "or all datums")
        if n_datum:
            return DatumExpression(lambda: transformer_expr.get
                                   .single_transform([d.get for d in data_deps]))
        if len(data_deps) == 1 and _overlap_enabled():
            # the fitted transformer exists only at force time: forcing
            # it here would run the fit eagerly
            dep = data_deps[0]
            return StreamingDatasetExpression(
                lambda: _streamed_batch(transformer_expr.get, dep))
        return DatasetExpression(lambda: transformer_expr.get
                                 .batch_transform([d.get for d in data_deps]))


class ExpressionOperator(Operator):
    """Wraps an already-computed Expression: the saved-state rule splices
    memoized results into a plan with it (Operator.scala:118-134)."""

    def __init__(self, expression: Expression, name: str = "saved"):
        self.expression = expression
        self.name = name

    @property
    def label(self) -> str:
        return f"Saved[{self.name}]"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        return self.expression


class GatherTransformerOperator(TransformerOperator):
    """Zips N branches (GatherTransformerOperator.scala:9-18): a list of
    the inputs for one datum; the datasets zipped row by row
    (`zip_datasets`) for a batch."""

    @property
    def label(self) -> str:
        return "Gather"

    def single_transform(self, inputs: List[Any]) -> Any:
        return list(inputs)

    def batch_transform(self, inputs: List[Any]) -> Any:
        from ..data.dataset import zip_datasets

        return zip_datasets(inputs)


def fitted_elem_fn(transformer: TransformerOperator):
    """Element → element function of an already-fitted transformer, for
    shape checks that touch no data (`keystone_tpu/workflow/operators.py`
    `fitted_elem_fn`): its ``abstract_apply`` hook when it has one, else
    its single-item path on the element, which callers pass as a tensor
    on torch's ``meta`` device (shape and dtype, no storage)."""

    def fn(elem):
        hook = getattr(transformer, "abstract_apply", None)
        if hook is not None:
            return hook(elem)
        return transformer.single_transform([elem])

    return fn
