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
`SparseDataset`) and a single datum. The JAX package's static
``abstract_eval`` hooks (its analysis tiers) and its overlap-engine
branches have no counterpart here yet.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from .expressions import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)


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
