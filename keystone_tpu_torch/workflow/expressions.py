"""Lazy, memoized value wrappers passed between operators.

Counterpart of `keystone_tpu/workflow/expressions.py:27-192` (reference
workflow/Expression.scala:9-44): an `Expression` wraps a call-by-name
computation and forces it at most once. `DatasetExpression` holds a
dataset (a `Dataset`, `HostDataset`, `SparseDataset` or any batch
container), `DatumExpression` a single item, and `TransformerExpression`
a fitted transformer (forcing it runs the fit).
`StreamingDatasetExpression` (`:72-184`) is a dataset that arrives chunk
by chunk from the overlap engine (`utils/batching.py`): ``iter_chunks``
memoizes what it drained, so an interrupted drain resumes and never
re-runs its producer, and a failed producer stays failed. A chunk's
payload is a tensor whose rows are its items (or a list of items); the
drained chunks assemble into a `HostDataset` whose buckets they are.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

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


# Chunk protocol: a stream yields ``(indices, payload)`` pairs. With
# ``indices`` a list of positions in the original item order, ``payload``
# holds the results for those positions, one row (or list entry) an item;
# the union of all indices is range(n). With ``indices is None`` the stage
# could not stream and ``payload`` is its whole value.
Chunk = Tuple[Optional[List[int]], Any]


class StreamingDatasetExpression(DatasetExpression):
    """A dataset expression whose value arrives chunk by chunk.

    ``chunks_thunk`` is called at most once and returns an iterator of
    `Chunk`s. ``iter_chunks()`` drains it while memoizing, so after a
    full drain (or a ``.get``) the expression behaves as a forced
    `DatasetExpression`. Interleaved partial drains by two consumers
    raise. ``placement``, where given, returns the stage's input once
    the stream is drained: a `HostDataset` assembled from the chunks
    takes its mesh placement (`data/dataset.py::keep_host_placement`)."""

    __slots__ = ("_chunks_thunk", "_placement", "_draining", "_drained",
                 "_live_iter", "_failed")

    def __init__(self, chunks_thunk: Callable[[], Iterator[Chunk]],
                 placement: Optional[Callable[[], Any]] = None):
        super().__init__(self._materialize)
        self._chunks_thunk = chunks_thunk
        self._placement = placement
        self._draining = False
        # chunks pulled so far and the suspended producer: a consumer
        # that stops mid-stream must not make a later force re-run it
        self._drained: List[Chunk] = []
        self._live_iter: Optional[Iterator[Chunk]] = None
        # a producer failure is sticky: a later force re-raises instead
        # of assembling the truncated prefix
        self._failed: Optional[BaseException] = None

    def _materialize(self):
        for _ in self.iter_chunks():
            pass
        return self._value

    @staticmethod
    def _assemble(indexed: List[Tuple[List[int], Any]]):
        from ..data.dataset import HostDataset

        import torch

        n = sum(len(idxs) for idxs, _ in indexed)
        if all(isinstance(p, torch.Tensor) for _, p in indexed):
            return HostDataset.from_buckets(
                [(list(idxs), payload) for idxs, payload in indexed], n)
        out: List[Any] = [None] * n
        for idxs, items in indexed:
            for i, item in zip(idxs, items):
                out[i] = item
        return HostDataset(out)

    def iter_chunks(self) -> Iterator[Chunk]:
        """Yield the chunks, memoizing the assembled value at the end.
        ``chunks_thunk`` runs at most once, even across interrupted
        consumers: the next ``iter_chunks()`` (or ``.get``) replays the
        pulled prefix and resumes the producer."""
        if self.is_forced:
            yield None, self._value
            return
        if self._failed is not None:
            raise self._failed
        if self._draining:
            raise RuntimeError(
                "StreamingDatasetExpression is already being drained; "
                "interleaved chunk consumers are not supported")
        self._draining = True
        try:
            for chunk in self._drained:
                yield chunk
            if self._live_iter is None:
                self._live_iter = self._chunks_thunk()
            try:
                for chunk in self._live_iter:
                    self._drained.append(chunk)
                    yield chunk
            except GeneratorExit:
                raise  # early close: prefix and live iterator stay
            except BaseException as e:
                self._failed = e
                raise
            indexed: List[Tuple[List[int], Any]] = []
            whole = _UNSET
            for idxs, payload in self._drained:
                if idxs is None:
                    whole = payload
                else:
                    indexed.append((idxs, payload))
            self._value = (whole if whole is not _UNSET
                           else self._assemble(indexed))
            if self._placement is not None:
                from ..data.dataset import keep_host_placement

                self._value = keep_host_placement(self._value,
                                                  self._placement())
            self._thunk = None
            self._chunks_thunk = None
            self._live_iter = None
            self._drained = []
        finally:
            self._draining = False

    def map_chunks(self, chunk_fn: Callable[[Any], Any],
                   whole_fn: Callable[[Any], Any]
                   ) -> "StreamingDatasetExpression":
        """A stage applied lazily a chunk at a time: ``chunk_fn`` maps a
        chunk's payload to the payload of its results, ``whole_fn`` the
        whole-value chunk."""

        def thunk():
            for idxs, payload in self.iter_chunks():
                if idxs is None:
                    yield None, whole_fn(payload)
                else:
                    yield idxs, chunk_fn(payload)

        return StreamingDatasetExpression(thunk, lambda: self.get)


class TransformerExpression(Expression):
    """Wraps a (lazy) fitted TransformerOperator (Expression.scala:32-44).

    Forcing `.get` is what runs an estimator's fit, the "fit happens
    here" point of the reference call stack (Operator.scala:136-163).
    """
