"""Abstract value specs flowing through the static pipeline analyzer.

Counterpart of `keystone_tpu/analysis/specs.py:1-375`. The analyzer
(`propagate.py::spec_pass`) walks a lowered `Graph` in topological order
and gives each vertex a *spec*, an abstract description of what the
vertex would produce at force time, without touching any data:

  - ``DataSpec``: a dataset or datum, a pytree (tuples, lists, dicts) of
    `ShapeDtype` element specs plus an example count;
  - ``TransformerSpec``: the output of an estimator node, an abstract
    fitted transformer, optionally carrying an element → element shape
    function so the downstream apply's spec is known before the fit;
  - ``UNKNOWN``: host objects (strings, token lists, images of varying
    size) and stages that cannot run abstractly. Unknown in, unknown
    out: never an error by itself.

Where the JAX package holds a `jax.ShapeDtypeStruct`, the port holds its
own frozen `ShapeDtype` (a shape and a torch dtype), and where JAX runs
`jax.eval_shape`, `trace_element` runs the stage body on tensors on
torch's ``meta`` device: shapes and dtypes, no storage, no arithmetic,
no launch. A body that needs values (``.item()``, ``.cpu()``,
``.numpy()``, Python on the data) fails there, and the stage is host
code: its spec is UNKNOWN, as JAX's tracer errors make it.

This module imports nothing from `workflow`, so operator classes can
import it lazily without cycles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Unknown:
    """Singleton bottom spec: statically unknowable, not an error."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNKNOWN"

    def __reduce__(self):
        return (_Unknown, ())


UNKNOWN = _Unknown()


class SpecMismatchError(Exception):
    """An abstract-eval hook proved the pipeline cannot run: shapes,
    dtypes, counts or arity are inconsistent. Carries the analyzer rule
    id so `spec_pass` files the diagnostic under the right lint."""

    def __init__(self, message: str, rule: str = "KP101"):
        super().__init__(message)
        self.rule = rule


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return got


def dtype_name(dtype) -> str:
    """``float32``, ``int64``, ``bfloat16``, ...: a dtype's short name."""
    return str(torch_dtype(dtype)).replace("torch.", "")


@dataclass(frozen=True)
class ShapeDtype:
    """One array leaf of an element spec: its shape and torch dtype (the
    port's `jax.ShapeDtypeStruct`)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def meta(self) -> torch.Tensor:
        """An empty tensor of this shape and dtype on the meta device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def __repr__(self) -> str:
        return f"ShapeDtype({self.shape}, {dtype_name(self.dtype)})"


def shape_struct(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(int(s) for s in shape), torch_dtype(dtype))


def tree_leaves(tree) -> list:
    """The leaves of a pytree of tuples, lists and dicts, in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf, its structure kept."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, sub) for sub in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def is_known(spec: Any) -> bool:
    return spec is not UNKNOWN and spec is not None


def element_nbytes(element: Any) -> Optional[int]:
    """Bytes of one element (a pytree of `ShapeDtype`), or None when the
    element spec is UNKNOWN or holds unknown leaves."""
    if not is_known(element):
        return None
    total = 0
    for leaf in tree_leaves(element):
        if not isinstance(leaf, ShapeDtype):
            return None
        total += leaf.nbytes
    return total


@dataclass(frozen=True)
class DataSpec:
    """Abstract dataset or datum: element pytree + example count.

    ``streaming`` marks values that arrive chunk by chunk under the
    overlap engine (a stream-producing stage, or a chunkable stage fed
    by one); the hazard pass keys on it."""

    element: Any = UNKNOWN  # pytree of ShapeDtype, or UNKNOWN
    count: Optional[int] = None
    kind: str = "dataset"  # "dataset" | "datum"
    on_device: bool = True
    streaming: bool = False

    @property
    def nbytes(self) -> Optional[int]:
        """Full materialized size (count × element bytes); None when
        unknowable."""
        per = element_nbytes(self.element)
        if per is None:
            return None
        if self.kind == "datum":
            return per
        if self.count is None:
            return None
        return per * int(self.count)

    def __repr__(self) -> str:
        def fmt(e):
            if not is_known(e):
                return "?"
            if isinstance(e, ShapeDtype):
                return f"{e.shape}:{dtype_name(e.dtype)}"
            return repr(tree_map(
                lambda l: f"{l.shape}:{dtype_name(l.dtype)}", e))

        n = "?" if self.count is None else self.count
        tag = "~stream" if self.streaming else ""
        return f"DataSpec[{self.kind} n={n} elem={fmt(self.element)}{tag}]"


@dataclass(frozen=True)
class TransformerSpec:
    """Abstract fitted transformer (the spec of a TransformerExpression).

    ``elem_fn`` maps an input element spec to the fitted transformer's
    output element spec; it may raise `SpecMismatchError` when the input
    provably cannot feed the model. None means the estimator declared
    nothing: downstream applies propagate UNKNOWN."""

    elem_fn: Optional[Callable[[Any], Any]] = field(default=None,
                                                    compare=False)
    label: str = ""
    chunkable: bool = False

    def apply_element(self, element: Any) -> Any:
        if self.elem_fn is None or not is_known(element):
            return UNKNOWN
        return self.elem_fn(element)

    def __repr__(self) -> str:
        known = "known" if self.elem_fn is not None else "opaque"
        return f"TransformerSpec[{self.label or 'fitted'}:{known}]"


class SpecDataset:
    """A dataset placeholder carrying only an abstract spec.

    Builds example pipelines for validation without loading any data:
    `Pipeline.apply` and `Estimator.with_data` accept it (it is flagged
    ``is_dataset``), the graph wires up exactly as with real data, and
    `DatasetOperator.abstract_eval` reads the declared spec; any attempt
    to force the pipeline fails loudly. ``shape=None`` declares a host
    dataset of opaque objects (strings, images of varying size)."""

    is_dataset = True

    def __init__(self, shape=None, dtype=np.float32,
                 count: Optional[int] = None, on_device: bool = True,
                 name: str = "spec", element=None):
        if element is None and shape is not None:
            element = shape_struct(shape, dtype)
        self.spec = DataSpec(
            element=element if element is not None else UNKNOWN,
            count=count,
            kind="dataset",
            on_device=on_device if element is not None else False,
        )
        self.name = name

    @property
    def count(self) -> Optional[int]:
        return self.spec.count

    def __len__(self) -> int:
        if self.spec.count is None:
            raise TypeError(f"SpecDataset {self.name!r} has no declared "
                            "count")
        return self.spec.count

    def __repr__(self) -> str:
        return f"SpecDataset[{self.name}]({self.spec})"

    def _refuse(self, what: str):
        raise RuntimeError(
            f"SpecDataset {self.name!r} is an abstract placeholder for "
            f"static validation; {what} would require real data. Build the "
            "pipeline with a real Dataset/HostDataset to execute it.")

    @property
    def array(self):
        self._refuse("reading .array")

    @property
    def data(self):
        self._refuse("reading .data")

    @property
    def items(self):
        self._refuse("reading .items")

    def numpy(self):
        self._refuse("collecting to numpy")

    def cache(self):
        return self


def _leaf_of(t) -> ShapeDtype:
    return ShapeDtype(tuple(int(s) for s in t.shape), t.dtype)


def spec_of(value: Any) -> Any:
    """Best-effort spec of a concrete value (`DatasetOperator`,
    `DatumOperator` and forced `ExpressionOperator`s)."""
    from ..data.dataset import Dataset, HostDataset

    if isinstance(value, SpecDataset):
        return value.spec
    if getattr(value, "is_out_of_core", False) \
            or getattr(value, "is_spilled", False):
        # host-resident (`:228-242`): the element from one row, off the
        # card, so no pass charges its whole payload to the card
        element = UNKNOWN
        try:
            row = value.row_loader(0, 1)
            parts = row if isinstance(row, tuple) else (row,)
            leaves = tuple(ShapeDtype(tuple(p.shape[1:]), torch_dtype(p.dtype))
                           for p in parts)
            element = leaves if isinstance(row, tuple) else leaves[0]
        except (AttributeError, IndexError, TypeError, ValueError):
            pass
        return DataSpec(element=element, count=value.count, kind="dataset",
                        on_device=False)
    if isinstance(value, Dataset):
        data = value.data
        element = (tuple(ShapeDtype(tuple(p.shape[1:]), p.dtype)
                         for p in data) if isinstance(data, tuple)
                   else ShapeDtype(tuple(data.shape[1:]), data.dtype))
        if getattr(value, "tiled", False):
            # a column tile is one rank's share of the element
            element = ShapeDtype((value.width,), data.dtype)
        return DataSpec(element=element, count=value.count, kind="dataset",
                        on_device=True)
    if isinstance(value, HostDataset):
        element = UNKNOWN
        items = value.items
        if items:
            first = items[0]
            if isinstance(first, torch.Tensor):
                element = _leaf_of(first)
            elif isinstance(first, np.ndarray):
                element = ShapeDtype(tuple(first.shape),
                                     torch_dtype(first.dtype))
        return DataSpec(element=element, count=len(items), kind="dataset",
                        on_device=False)
    if isinstance(value, torch.Tensor):
        return DataSpec(element=_leaf_of(value), kind="datum",
                        on_device=True)
    if isinstance(value, np.ndarray):
        try:
            element = ShapeDtype(tuple(value.shape),
                                 torch_dtype(value.dtype))
        except TypeError:
            return UNKNOWN
        return DataSpec(element=element, kind="datum", on_device=False)
    return UNKNOWN


def as_source_spec(spec: Any) -> Any:
    """Normalize `Pipeline.validate`'s ``source_spec``: a DataSpec, a
    SpecDataset, a ShapeDtype (one element), a ``(shape, dtype)`` pair, a
    bare shape tuple (float32), or None (UNKNOWN source)."""
    if spec is None or spec is UNKNOWN:
        return UNKNOWN
    if isinstance(spec, DataSpec):
        return spec
    if isinstance(spec, SpecDataset):
        return spec.spec
    if isinstance(spec, ShapeDtype):
        return DataSpec(element=spec, kind="dataset")
    if isinstance(spec, tuple) and len(spec) == 2 \
            and not isinstance(spec[0], int):
        return DataSpec(element=shape_struct(*spec), kind="dataset")
    if isinstance(spec, tuple) and all(isinstance(s, int) for s in spec):
        return DataSpec(element=shape_struct(spec, np.float32),
                        kind="dataset")
    raise TypeError(f"cannot interpret {spec!r} as a source spec")


def leaf_vector_dim(spec: Any) -> Optional[int]:
    """Length of a dataset spec's 1-D single-leaf element, else None."""
    if not isinstance(spec, DataSpec) or not is_known(spec.element):
        return None
    leaves = tree_leaves(spec.element)
    if len(leaves) == 1 and getattr(leaves[0], "ndim", None) == 1:
        return int(leaves[0].shape[0])
    return None


def supervised_fit_spec(in_specs, label: str, out_dtype=np.float32,
                        max_in_dim: Optional[int] = None) -> TransformerSpec:
    """TransformerSpec for the y = f(xW) family of supervised estimators
    (data (d,) + labels (k,) → a model mapping (d,) → (k,)).

    ``elem_fn`` checks the apply-time feature dim against the training
    dim (``max_in_dim`` relaxes it to ≤, for feature-padding solvers such
    as BlockLeastSquares) and yields the label-width output element.
    Opaque when the training specs are unknown."""
    data = in_specs[0] if in_specs else UNKNOWN
    labels = in_specs[1] if len(in_specs) > 1 else UNKNOWN
    d = leaf_vector_dim(data)
    k = leaf_vector_dim(labels)
    if k is None:
        return TransformerSpec(None, label=label)

    def elem_fn(elem):
        got = None
        leaves = tree_leaves(elem)
        if len(leaves) == 1 and getattr(leaves[0], "ndim", None) == 1:
            got = int(leaves[0].shape[0])
        if d is not None and got is not None:
            limit = max_in_dim if max_in_dim is not None else d
            bad = got > limit if max_in_dim is not None else got != d
            if bad:
                raise SpecMismatchError(
                    f"{label} was fit on {d}-dim features but is applied "
                    f"to a {got}-dim element")
        dtype = out_dtype if out_dtype is not None else leaves[0].dtype
        return shape_struct((k,), dtype)

    return TransformerSpec(elem_fn, label=label)


# ---------------------------------------------------------------- tracing

#: RuntimeError / NotImplementedError / TypeError substrings of a body
#: that needed values: `.item()`, `.cpu()`, `.numpy()` or a data-dependent
#: Python branch on a meta tensor. Such a stage is host code.
_HOST_CODE_MARKERS = ("meta", "numpy", "item()", "data-dependent",
                      "cannot be called", "not implemented")

#: substrings that identify a genuine shape or dtype complaint (the
#: stage provably cannot run on these inputs).
_SHAPE_ERROR_MARKERS = (
    "shape", "dtype", "dim", "broadcast", "rank", "incompatible",
    "matmul", "mat1", "cannot be multiplied", "size of tensor",
    "must match", "concatenat", "expected", "conv",
)


def to_meta(tree):
    """The pytree of `ShapeDtype` as meta tensors."""
    return tree_map(lambda leaf: leaf.meta(), tree)


def from_meta(out) -> Any:
    """The element spec of a traced body's output: tensors become
    `ShapeDtype`s (tuples and lists kept); anything else, a host value,
    is UNKNOWN."""
    if isinstance(out, torch.Tensor):
        return _leaf_of(out)
    if isinstance(out, (tuple, list)):
        parts = [from_meta(o) for o in out]
        if any(p is UNKNOWN for p in parts):
            return UNKNOWN
        return type(out)(parts)
    return UNKNOWN


def _meta_args(tree):
    """``tree`` with every tensor not on the meta device moved there."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.device.type == "meta" else tree.to("meta")
    if isinstance(tree, (tuple, list)):
        return type(tree)(_meta_args(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _meta_args(v) for k, v in tree.items()}
    return tree


def _any_meta(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.device.type == "meta"
    if isinstance(tree, (tuple, list)):
        return any(_any_meta(t) for t in tree)
    if isinstance(tree, dict):
        return any(_any_meta(v) for v in tree.values())
    return False


class MetaMode(TorchDispatchMode):
    """Runs a stage body on meta tensors: an op that meets a meta tensor
    and a stage's own parameters (fitted weights on the CPU or the card)
    sees the parameters as meta tensors too, so the op yields its shape
    and dtype and reads nothing. Ops on parameters alone run as they
    are."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _any_meta(args) or _any_meta(kwargs):
            args, kwargs = _meta_args(args), _meta_args(kwargs)
        return func(*args, **kwargs)


def trace_element(fn: Callable, elems) -> Any:
    """One per-item call over element specs, run on meta tensors: no data
    moves, no device memory is taken, no kernel is launched.

    Returns the output element pytree, UNKNOWN when ``fn`` is host code
    that cannot run on meta tensors, and raises `SpecMismatchError` when
    the call dies on a shape or dtype complaint."""
    try:
        with torch.no_grad(), MetaMode():
            out = fn(*[to_meta(e) for e in elems])
    except SpecMismatchError:
        raise
    except (AttributeError, KeyError, IndexError):
        return UNKNOWN
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        low = str(e).lower()
        if any(marker in low for marker in _HOST_CODE_MARKERS):
            return UNKNOWN
        if any(marker in low for marker in _SHAPE_ERROR_MARKERS):
            raise SpecMismatchError(str(e), rule="KP101") from e
        return UNKNOWN
    except Exception:
        return UNKNOWN
    return from_meta(out)
