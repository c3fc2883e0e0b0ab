"""Typed combinator API: Transformer / Estimator / LabelEstimator / Pipeline.

Counterpart of the part of `keystone_tpu/workflow/pipeline.py` that
RandomPatchCifar's `build_pipeline` and the evaluator use (reference
workflow/{Pipeline,Chainable,Transformer,Estimator,LabelEstimator,
PipelineResult}.scala). A pipeline is a chain of nodes. Applying it
returns a lazy `PipelineResult`; nothing runs until ``.get()``. An
estimator appended with ``and_then(est, data[, labels])`` is fit once,
the first time the chain runs through it, on this pipeline applied to
``data``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .executor import execute

_UNSET = object()


class PipelineResult:
    """Lazy handle on (node chain, input); `.get()` runs it once."""

    def __init__(self, nodes: Sequence, data: Any):
        self.nodes = tuple(nodes)
        self.data = data
        self._value = _UNSET

    def get(self):
        if self._value is _UNSET:
            data = self.data.get() if isinstance(self.data, PipelineResult) \
                else self.data
            self._value = execute(self.nodes, data)
        return self._value


def _value(x):
    return x.get() if isinstance(x, PipelineResult) else x


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

        The estimator trains on this pipeline applied to ``data``."""
        me = self.to_pipeline()
        if isinstance(nxt, Estimator) and len(fit_args) == 1:
            return me.and_then(nxt.with_data(me.apply(fit_args[0])))
        if isinstance(nxt, LabelEstimator) and len(fit_args) == 2:
            return me.and_then(
                nxt.with_data(me.apply(fit_args[0]), fit_args[1]))
        if fit_args:
            raise TypeError("and_then: unexpected fit arguments")
        return Pipeline(me.nodes + nxt.to_pipeline().nodes)

    def __rshift__(self, nxt) -> "Pipeline":
        return self.and_then(nxt)


class Pipeline(Chainable):
    """A chain of nodes (Pipeline.scala:22-155)."""

    def __init__(self, nodes: Sequence):
        self.nodes = tuple(nodes)

    def to_pipeline(self) -> "Pipeline":
        return self

    def apply(self, data: Any) -> PipelineResult:
        return PipelineResult(self.nodes, data)

    def __call__(self, data: Any) -> PipelineResult:
        return self.apply(data)


class Transformer(Chainable):
    """A batched tensor function (Transformer.scala:18-70). Subclasses
    implement `batch_fn`, which maps a (n, ...) tensor of rows to a
    (n, ...) tensor; `apply` runs it on one datum."""

    def batch_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        raise NotImplementedError

    def apply(self, x):
        return self.batch_fn()(torch.as_tensor(x)[None])[0]

    def apply_batch(self, data):
        return data.map_batches(self.batch_fn())

    def to_pipeline(self) -> Pipeline:
        return Pipeline((self,))

    def __call__(self, data: Any) -> PipelineResult:
        return self.to_pipeline().apply(data)


class Estimator(Chainable):
    """Unsupervised estimator: `fit(data) -> Transformer`
    (Estimator.scala:10-62)."""

    def fit(self, data) -> Transformer:
        raise NotImplementedError

    def with_data(self, data) -> Pipeline:
        """The fit-then-apply pipeline: one node that fits this estimator
        on ``data`` at first use and applies the fitted transformer."""
        return Pipeline((_Delegating(self, (data,)),))

    def to_pipeline(self):
        raise TypeError("an Estimator needs data: use .with_data(data)")


class LabelEstimator(Chainable):
    """Supervised estimator: `fit(data, labels) -> Transformer`
    (LabelEstimator.scala:13-100)."""

    def fit(self, data, labels) -> Transformer:
        raise NotImplementedError

    def with_data(self, data, labels) -> Pipeline:
        return Pipeline((_Delegating(self, (data, labels)),))

    def to_pipeline(self):
        raise TypeError(
            "a LabelEstimator needs data: use .with_data(data, labels)")


class _Delegating(Transformer):
    """Applies the transformer that ``estimator`` fits on ``fit_inputs``
    (lazy results or datasets); the fit runs once, at first use."""

    def __init__(self, estimator, fit_inputs: tuple):
        self.estimator = estimator
        self.fit_inputs = fit_inputs
        self._fitted = None

    @property
    def fitted(self) -> Transformer:
        if self._fitted is None:
            self._fitted = self.estimator.fit(
                *[_value(x) for x in self.fit_inputs])
        return self._fitted

    def apply(self, x):
        return self.fitted.apply(x)

    def apply_batch(self, data):
        return self.fitted.apply_batch(data)
