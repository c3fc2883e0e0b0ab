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
yields its whole value as one chunk.

Every operator has the static ``abstract_eval(in_specs)`` hook of the
analyzer (`:127, 155, 175, 236, 285, 362, 445, 480`): it maps its
dependencies' specs (`analysis/specs.py`) to its own without touching
data. A transformer runs its single-item path on meta tensors
(`analysis/specs.py::trace_element`) unless it declares
``abstract_apply``; an estimator declares its fitted transformer's shape
function with ``abstract_fit``. ``donates_deps`` (`:121`) names the
dependencies whose tensors an operator writes into in place: the hazard
pass (KP301) and the serving certifier (KP904) check them.
"""

from __future__ import annotations

import functools
from typing import Any, List, Sequence

import torch

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


def _training_input(dep: Expression):
    """A fit's input: a spilled or out-of-core value re-enters the card
    whole (`:313-326`), as a whole-batch consumer needs it."""
    value = dep.get
    if getattr(value, "is_spilled", False):
        return value.rehydrate()
    if getattr(value, "is_out_of_core", False):
        return value.materialize()
    return value


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


def _check_data_specs(in_specs: List[Any]):
    """The static form of `TransformerOperator.execute`'s argument checks
    (`:70-110`): no transformer consumed as data, no datum/dataset mix,
    agreeing dataset counts. Returns ``(kind, count, on_device, elems)``."""
    from ..analysis.specs import (
        UNKNOWN,
        DataSpec,
        SpecMismatchError,
        TransformerSpec,
    )

    if not in_specs:
        raise SpecMismatchError(
            "requires at least one data dependency", rule="KP002")
    for s in in_specs:
        if isinstance(s, TransformerSpec):
            raise SpecMismatchError(
                "a transformer output is consumed as data (fit-before-use)",
                rule="KP003")
    data = [s for s in in_specs if isinstance(s, DataSpec)]
    kinds = {s.kind for s in data}
    if kinds == {"datum", "dataset"}:
        raise SpecMismatchError(
            "dependencies mix datums and datasets", rule="KP002")
    kind = "datum" if kinds == {"datum"} else "dataset"
    counts = {s.count for s in data
              if s.kind == "dataset" and s.count is not None}
    if len(counts) > 1:
        raise SpecMismatchError(
            f"dependency datasets disagree on example count: "
            f"{sorted(counts)}", rule="KP102")
    count = next(iter(counts)) if counts else None
    on_device = data[0].on_device if data else True
    elems = [s.element if isinstance(s, DataSpec) else UNKNOWN
             for s in in_specs]
    return kind, count, on_device, elems


class Operator:
    """Base class. Subclasses implement ``execute``."""

    #: indices of dependencies whose tensor this operator writes into in
    #: place (the JAX package's donated buffers, `:113-121`)
    donates_deps: tuple = ()

    @property
    def label(self) -> str:
        return type(self).__name__

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        """Map dependency specs to this operator's output spec without
        touching data. Default: unknowable. Hooks raise
        `SpecMismatchError` when the inputs provably cannot work."""
        from ..analysis.specs import UNKNOWN

        return UNKNOWN

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

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import spec_of

        return spec_of(self.dataset)

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

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import UNKNOWN, DataSpec, spec_of

        spec = spec_of(self.datum)
        if isinstance(spec, DataSpec):
            return spec
        return DataSpec(element=UNKNOWN, kind="datum", on_device=False)

    def execute(self, deps: Sequence[Expression]) -> Expression:
        assert not deps
        return DatumExpression.of(self.datum)


def _gathers_model_tiles(fn):
    """``fn``, a batch path, taking its datasets' column tiles gathered
    over the model axis unless its operator is ``model_aware``
    (`parallel/mesh.py::gather_model_inputs`), and keeping a mesh
    `HostDataset`'s placement on the one it returns
    (`data/dataset.py::keep_host_placement`)."""
    from ..data.dataset import keep_host_placement
    from ..parallel.mesh import gather_model_inputs

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        args, kwargs = gather_model_inputs(self, args, kwargs)
        return keep_host_placement(fn(self, *args, **kwargs), args)

    return wrapped


class TransformerOperator(Operator):
    """An operator with both per-item and bulk execution paths
    (Operator.scala:37-100).

    Subclasses (every `Transformer` node) implement ``single_transform``
    and ``batch_transform``. If any dependency is a `DatumExpression` the
    single-item path runs, else the batch path. On a ``(data, model)``
    mesh a batch path (``batch_transform``, ``apply_batch``) reads its
    datasets' column tiles only where the class sets ``model_aware``;
    otherwise they reach it gathered over ``model``, as GSPMD gathers a
    model-sharded value for a stage that needs its columns whole."""

    #: whether the batch path runs on a dataset's column tile
    model_aware = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("batch_transform", "apply_batch"):
            fn = cls.__dict__.get(name)
            if fn is not None and callable(fn) \
                    and not hasattr(fn, "__wrapped__"):
                setattr(cls, name, _gathers_model_tiles(fn))

    def single_transform(self, inputs: List[Any]) -> Any:
        raise NotImplementedError

    def batch_transform(self, inputs: List[Any]) -> Any:
        raise NotImplementedError

    # ------------------------------------------------------ static analysis

    def _abstract_element(self, elems: List[Any]) -> Any:
        """Per-item output element spec: the ``abstract_apply(elem)``
        hook where one is declared, else ``single_transform`` run on
        meta tensors (`analysis/specs.py::trace_element`)."""
        from ..analysis.specs import trace_element

        hook = getattr(self, "abstract_apply", None)
        if hook is not None and len(elems) == 1:
            return hook(elems[0])
        return trace_element(
            lambda *xs: self.single_transform(list(xs)), elems)

    def _streams_out(self, in_specs: List[Any]) -> bool:
        from ..analysis.specs import DataSpec

        if is_stream_origin(self):
            return True
        in_streams = any(
            isinstance(s, DataSpec) and s.streaming for s in in_specs)
        return in_streams and bool(getattr(self, "chunkable", False))

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import UNKNOWN, DataSpec, is_known

        kind, count, on_device, elems = _check_data_specs(in_specs)
        if all(is_known(e) for e in elems):
            out_elem = self._abstract_element(elems)
        else:
            out_elem = UNKNOWN
        return DataSpec(
            element=out_elem,
            count=count if kind == "dataset" else None,
            kind=kind,
            on_device=on_device,
            streaming=kind == "dataset" and self._streams_out(in_specs),
        )

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
                lambda: _streamed_batch(self, dep), lambda: dep.get)
        return DatasetExpression(
            lambda: self.batch_transform([d.get for d in deps]))


class EstimatorOperator(Operator):
    """Fits on datasets, lazily producing a TransformerOperator
    (Operator.scala:102-116)."""

    def fit_datasets(self, inputs: List[Any]) -> TransformerOperator:
        raise NotImplementedError

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        """Static fit: count agreement across training datasets, then
        the estimator's ``abstract_fit(in_specs) -> TransformerSpec``
        hook where it declares one; opaque otherwise."""
        from ..analysis.specs import (
            DataSpec,
            SpecMismatchError,
            TransformerSpec,
        )

        if not in_specs:
            raise SpecMismatchError(
                "estimator requires training data dependencies",
                rule="KP002")
        counts = {s.count for s in in_specs
                  if isinstance(s, DataSpec) and s.kind == "dataset"
                  and s.count is not None}
        if len(counts) > 1:
            raise SpecMismatchError(
                f"training datasets disagree on example count: "
                f"{sorted(counts)}", rule="KP102")
        hook = getattr(self, "abstract_fit", None)
        if hook is not None:
            return hook(in_specs)
        return TransformerSpec(None, label=self.label)

    def execute(self, deps: Sequence[Expression]) -> Expression:
        deps = list(deps)
        return TransformerExpression(
            lambda: self.fit_datasets([_training_input(d) for d in deps]))


class DelegatingOperator(Operator):
    """Applies the transformer produced by its first dependency to the rest
    (Operator.scala:136-163). Forcing the transformer expression is the
    moment an estimator's fit happens."""

    #: dependency indices that consume an estimator output (KP003
    #: fit-before-use exempts these; see `analysis.propagate`)
    estimator_positions: tuple = (0,)

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import (
            UNKNOWN,
            DataSpec,
            SpecMismatchError,
            TransformerSpec,
            is_known,
        )

        if not in_specs:
            raise SpecMismatchError(
                "DelegatingOperator requires a transformer dependency",
                rule="KP002")
        tspec, data_specs = in_specs[0], in_specs[1:]
        if isinstance(tspec, DataSpec):
            raise SpecMismatchError(
                "first dependency produces data, not a transformer",
                rule="KP004")
        if not data_specs:
            raise SpecMismatchError(
                "DelegatingOperator requires data dependencies",
                rule="KP002")
        kind, count, on_device, elems = _check_data_specs(data_specs)
        out_elem = UNKNOWN
        if isinstance(tspec, TransformerSpec) and len(elems) == 1 \
                and is_known(elems[0]):
            out_elem = tspec.apply_element(elems[0])  # may raise mismatch
        in_streams = any(
            isinstance(s, DataSpec) and s.streaming for s in data_specs)
        chunkable = isinstance(tspec, TransformerSpec) and tspec.chunkable
        return DataSpec(
            element=out_elem,
            count=count if kind == "dataset" else None,
            kind=kind,
            on_device=on_device,
            streaming=kind == "dataset" and in_streams and chunkable,
        )

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
                lambda: _streamed_batch(transformer_expr.get, dep),
                lambda: dep.get)
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

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import UNKNOWN, TransformerSpec, spec_of

        if isinstance(self.expression, TransformerExpression):
            if self.expression.is_forced:
                fitted = self.expression.get
                return TransformerSpec(
                    fitted_elem_fn(fitted), label=self.label,
                    chunkable=bool(getattr(fitted, "chunkable", False)))
            return TransformerSpec(None, label=self.label)
        if self.expression.is_forced:
            return spec_of(self.expression.get)
        return UNKNOWN

    def execute(self, deps: Sequence[Expression]) -> Expression:
        return self.expression


class GatherTransformerOperator(TransformerOperator):
    """Zips N branches (GatherTransformerOperator.scala:9-18): a list of
    the inputs for one datum; the datasets zipped row by row
    (`zip_datasets`) for a batch."""

    #: value-preserving plumbing: the certifier looks through the zip
    precision_passthrough = True

    @property
    def label(self) -> str:
        return "Gather"

    def abstract_eval(self, in_specs: List[Any]) -> Any:
        from ..analysis.specs import UNKNOWN, DataSpec, is_known

        kind, count, on_device, elems = _check_data_specs(in_specs)
        out_elem = (tuple(elems) if all(is_known(e) for e in elems)
                    else UNKNOWN)
        return DataSpec(element=out_elem,
                        count=count if kind == "dataset" else None,
                        kind=kind, on_device=on_device)

    def single_transform(self, inputs: List[Any]) -> Any:
        return list(inputs)

    def batch_transform(self, inputs: List[Any]) -> Any:
        from ..data.dataset import zip_datasets

        return zip_datasets(inputs)


def fitted_elem_fn(transformer: TransformerOperator):
    """Element → element spec function of an already-fitted transformer
    (`keystone_tpu/workflow/operators.py:329-345`): its ``abstract_apply``
    hook when it has one, else its single-item path run on meta tensors.
    Given a meta tensor rather than a spec, it returns the output tensor."""

    def fn(elem):
        from ..analysis.specs import trace_element

        if isinstance(elem, torch.Tensor):
            return transformer.single_transform([elem])
        hook = getattr(transformer, "abstract_apply", None)
        if hook is not None:
            return hook(elem)
        return trace_element(
            lambda x: transformer.single_transform([x]), (elem,))

    return fn
