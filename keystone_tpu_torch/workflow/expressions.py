"""Lazy, memoized value wrappers passed between operators.

Counterpart of `keystone_tpu/workflow/expressions.py:27-70, 186-192`
(reference workflow/Expression.scala:9-44): an `Expression` wraps a
call-by-name computation and forces it at most once. `DatasetExpression`
holds a dataset (a `Dataset`, `HostDataset`, `SparseDataset` or any batch
container), `DatumExpression` a single item, and `TransformerExpression`
a fitted transformer (forcing it runs the fit). The JAX package's
`StreamingDatasetExpression` (`:72-184`) belongs to its overlap engine,
which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Callable

_UNSET = object()


class Expression:
    """Base lazy memoized cell."""

    __slots__ = ("_thunk", "_value")

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._value = _UNSET

    @property
    def get(self) -> Any:
        if self._value is _UNSET:
            self._value = self._thunk()
            self._thunk = None  # release captured state
        return self._value

    @property
    def is_forced(self) -> bool:
        return self._value is not _UNSET

    @classmethod
    def of(cls, value: Any) -> "Expression":
        e = cls(None)
        e._value = value
        return e


class DatasetExpression(Expression):
    """Wraps a (lazy) dataset (Expression.scala:14-21)."""


class DatumExpression(Expression):
    """Wraps a (lazy) single datum (Expression.scala:23-30)."""


class TransformerExpression(Expression):
    """Wraps a (lazy) fitted TransformerOperator (Expression.scala:32-44).

    Forcing `.get` is what runs an estimator's fit, the "fit happens
    here" point of the reference call stack (Operator.scala:136-163).
    """
