"""Request schemas for the serving runtime's declared ingress boundaries.

Counterpart of `keystone_tpu/serving/ingress.py`. The certificate is
issued at a declared ingress, so the runtime holds the same line: a
request is admitted only where it matches the declared element, and the
work upstream of the boundary runs on the caller's thread, never on the
dispatch path.

  - `NdarrayIngress`: one request is one fixed-shape array row (the
    declared element's shape; a castable dtype is cast). A mismatch is
    an `IngressError` at submit time, never an off-ladder shape at
    dispatch.
  - `TextIngress`: the Newsgroups modality. The fitted host front-end
    (Trim → LowerCase → Tokenizer → n-grams → √TF → sparse vectorize)
    runs a request at ingress, and the runtime serves the device tail
    (naive Bayes scoring → argmax). `split_fitted_at` makes the split on
    the fitted graph, so both halves come from one fitted artifact.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np


class IngressError(ValueError):
    """A request that violates the declared ingress element — refused
    at submit time (the static-refusal discipline: never discovered as
    a recompile or a shape error mid-dispatch)."""


class NdarrayIngress:
    """Fixed-shape array ingress: one request row of ``shape``/``dtype``
    (the `SERVING_INGRESS` declared element). ``accept`` returns the
    validated row as a contiguous host array."""

    def __init__(self, shape: Tuple[int, ...], dtype: Any = np.float32):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)

    def accept(self, payload: Any) -> np.ndarray:
        try:
            row = np.asarray(payload)
        except Exception as e:
            raise IngressError(f"request payload is not array-like: {e}")
        if tuple(row.shape) != self.shape:
            raise IngressError(
                f"request shape {tuple(row.shape)} does not match the "
                f"declared ingress element {self.shape} — the certificate "
                "was issued at this boundary and the warmed manifest "
                "covers only it")
        if row.dtype != self.dtype:
            # a widening/narrowing cast is cheap and unambiguous; a
            # non-castable payload is a schema violation
            try:
                row = row.astype(self.dtype)
            except (TypeError, ValueError) as e:
                raise IngressError(
                    f"request dtype {row.dtype} does not cast to the "
                    f"declared {self.dtype}: {e}")
        return np.ascontiguousarray(row)

    def describe(self) -> dict:
        return {"kind": "ndarray", "shape": list(self.shape),
                "dtype": str(self.dtype)}


def _dense_row(x: Any, dtype) -> np.ndarray:
    """One request's vectorized row as a dense host array: a scipy
    sparse row densified, a tensor copied to the host."""
    import scipy.sparse as sp
    import torch

    if sp.issparse(x):
        return np.asarray(x.todense(), dtype)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class TextIngress:
    """Pre-tokenizing text ingress: the fitted host front-end stages run
    per request on the submitting thread, producing the dense feature
    row the device tail was certified over. ``host_ops`` are the fitted
    per-item transformers upstream of the declared boundary, in apply
    order (`split_fitted_at` extracts them)."""

    def __init__(self, host_ops: List[Any], dtype: Any = np.float32):
        if not host_ops:
            raise ValueError("TextIngress requires at least one host stage")
        self.host_ops = list(host_ops)
        self.dtype = np.dtype(dtype)

    def accept(self, payload: Any) -> np.ndarray:
        if not isinstance(payload, str):
            raise IngressError(
                f"text ingress expects a document string, got "
                f"{type(payload).__name__}")
        x: Any = payload
        try:
            for op in self.host_ops:
                x = op.apply(x)
        except Exception as e:
            raise IngressError(
                f"host front-end failed at ingress "
                f"({type(e).__name__}: {e})")
        row = _dense_row(x, self.dtype)
        if row.ndim == 2 and row.shape[0] == 1:
            row = row[0]
        return np.ascontiguousarray(row)

    def describe(self) -> dict:
        return {"kind": "text",
                "host_stages": [getattr(op, "label", type(op).__name__)
                                for op in self.host_ops],
                "dtype": str(self.dtype)}


def split_fitted_at(fitted, boundary_label: str):
    """Split a fitted pipeline at the first apply-path stage labeled
    ``boundary_label``: the host prefix (every stage strictly upstream)
    is returned as per-item transformers for a `TextIngress`, and the
    device tail (the boundary stage through the sink) as a new
    `FittedPipeline` whose source feeds the boundary directly: the graph
    the runtime certifies, warms and serves.

    The prefix must be a linear single-dependency chain rooted at the
    pipeline source (the Newsgroups front-end shape); fan-out or extra
    state deps upstream of the boundary raise ``ValueError`` rather
    than silently serving a different computation."""
    from ..analysis.serving import apply_path
    from ..workflow.pipeline import FittedPipeline

    graph = fitted.graph
    path = apply_path(graph, fitted.source, fitted.sink)
    split = next((i for i, vid in enumerate(path)
                  if graph.get_operator(vid).label == boundary_label), None)
    if split is None:
        labels = [graph.get_operator(v).label for v in path]
        raise ValueError(
            f"boundary stage {boundary_label!r} is not on the apply path "
            f"{labels}")
    prefix, boundary = path[:split], path[split]
    host_ops = []
    expect_dep = fitted.source
    for vid in prefix:
        deps = graph.get_dependencies(vid)
        if tuple(deps) != (expect_dep,):
            raise ValueError(
                f"ingress prefix stage {graph.get_operator(vid).label!r} "
                f"is not a linear chain from the source (deps={deps}) — "
                "cannot split the host front-end off this graph")
        host_ops.append(graph.get_operator(vid))
        expect_dep = vid
    tail = graph
    last = prefix[-1] if prefix else None
    if last is not None:
        deps = [fitted.source if d == last else d
                for d in tail.get_dependencies(boundary)]
        tail = tail.set_dependencies(boundary, deps)
        for vid in reversed(prefix):
            tail = tail.remove_node(vid)
    return host_ops, FittedPipeline(tail, fitted.source, fitted.sink)
