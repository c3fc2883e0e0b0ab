"""Chain kernels: a trail of fused stages lowered to one kernel launch.

Counterpart of `keystone_tpu/ops/chain_kernels.py`: the registry of
elementwise stage bodies (`_ELEMENTWISE`, `:157-250`), the
``(key, "masked")`` unwrapping (`:253-266`), `lowerability` with
`SUPPRESSED_STAGES` (`:143-150, 278-306`), the plain version
`elementwise_chain_reference` (`:413-452`) and `build_chain_fn`
(`:658-683`). Two families lower:

- ``rectify_pool_vectorize``: ``RectifyPool >> Vectorizer`` runs the
  rectify+pool kernel and flattens its output
  (`ops/kernels.py::rectify_pool_vectorize`);
- ``elementwise_chain``: a run of per-row stage bodies runs
  `elementwise_chain`, the CUDA kernel in ``csrc/elementwise_chain.cu``
  that replaces `elementwise_chain_pallas` (`:504-577`).

A chain is the static keys of its stages, ``(head, ...)`` wrapped as
``(key, "masked")`` when the stage re-zeroes padded rows, and one
parameter tuple per stage, as the nodes' ``fuse`` methods give them. The
TPU's VMEM block choosers and compile canaries (`:61-133, 614-655`) have
no counterpart: a block of the CUDA kernel holds one row in shared
memory, and the wrapper raises when a row does not fit.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.images import grayscale
from . import _build
from .kernels import (
    MAX_SMEM_BYTES,
    _check_cuda,
    _raise_on_error,
    _stream,
    rectify_pool_vectorize,
)

#: stages no chain kernel absorbs, each with the reason why
SUPPRESSED_STAGES = {
    "ConvRectifyPool": "already one fused kernel (ops.kernels."
                       "conv_rectify_pool)",
    "PaddedFFT": "an FFT is no per-row elementwise body; it stays on "
                 "torch.fft",
    "Pooler": "non-sum/pixel_fn pooling (the sum form peepholes into "
              "RectifyPool) stays on torch's pooling",
    "opaque": "id-keyed opaque stage: no static body to lower",
}


@dataclass(frozen=True)
class _Body:
    """One stage of the elementwise family."""

    code: int                 # stage code in csrc/elementwise_chain.cu
    vectors: int              # parameters broadcast along the last axis
    scalars: int              # scalar parameters
    fn: Callable              # plain body: (x, vectors, scalars) -> y
    shape: Callable = lambda s: s   # item shape in -> item shape out


def _gray_shape(shape):
    if shape[-1] not in (1, 3):
        raise ValueError(f"GrayScaler needs 1 or 3 channels, not "
                         f"{shape[-1]}")
    return shape[:-1] + (1,)


def _normalize_rows(x, v, s):
    norms = torch.sqrt((x * x).sum(dim=tuple(range(1, x.ndim)),
                                   keepdim=True))
    return x / torch.maximum(norms, s[0])


_BODIES = {
    "PixelScaler": _Body(0, 0, 0, lambda x, v, s: x.to(torch.float32)
                         / 255.0),
    "GrayScaler": _Body(1, 0, 0, lambda x, v, s: grayscale(x), _gray_shape),
    "ImageVectorizer": _Body(2, 0, 0, lambda x, v, s: x.reshape(
        x.shape[0], -1), lambda s: (math.prod(s),)),
    "LinearRectifier": _Body(3, 0, 2, lambda x, v, s: torch.maximum(
        s[0], x - s[1])),
    "NormalizeRows": _Body(4, 0, 1, _normalize_rows),
    "SignedHellingerMapper": _Body(5, 0, 0, lambda x, v, s: torch.sign(x)
                                   * torch.sqrt(torch.abs(x))),
    "RandomSignNode": _Body(6, 1, 0, lambda x, v, s: x * v[0]),
    ("StandardScaler", "scale"): _Body(7, 2, 0, lambda x, v, s: (x - v[0])
                                       / v[1]),
    ("StandardScaler", "center"): _Body(8, 1, 0, lambda x, v, s: x - v[0]),
}
_BODIES["MatrixVectorizer"] = _BODIES["ImageVectorizer"]


def _unwrap(key):
    """Strip the ``(key, "masked")`` wrapping; returns (inner_key,
    masked)."""
    masked = False
    while isinstance(key, tuple) and len(key) == 2 and key[1] == "masked":
        key, masked = key[0], True
    return key, masked


def _head(key):
    key, _ = _unwrap(key)
    if isinstance(key, tuple) and key:
        return key[0]
    return key


def _body(key) -> Optional[_Body]:
    """The registered body for a stage key, or None. StandardScaler's
    key carries its form (``"scale"`` when absent, as in JAX)."""
    inner, _ = _unwrap(key)
    head = _head(inner)
    if head == "StandardScaler":
        mode = inner[1] if isinstance(inner, tuple) and len(inner) > 1 \
            else "scale"
        return _BODIES.get(("StandardScaler", mode))
    return _BODIES.get(head)


def _registered(head) -> bool:
    return head == "StandardScaler" or head in _BODIES


def lowerability(statics) -> dict:
    """Verdict for a chain's static keys: ``lowerable`` (bool),
    ``family`` (str or None), ``reason`` (why it lowers or why not), and
    ``suppressed`` (stage → reason) when every blocker is a deliberate
    `SUPPRESSED_STAGES` entry."""
    statics = tuple(statics)
    heads = [_head(k) for k in statics]
    if len(statics) < 2:
        return {"lowerable": False, "family": None,
                "reason": "chain shorter than 2 fused stages"}
    if (len(statics) == 2 and heads[0] == "RectifyPool"
            and heads[1] in ("ImageVectorizer", "MatrixVectorizer")):
        return {"lowerable": True, "family": "rectify_pool_vectorize",
                "reason": "RectifyPool >> Vectorizer: one kernel writes "
                          "only the pooled-flat output"}
    if all(_registered(h) for h in heads):
        return {"lowerable": True, "family": "elementwise_chain",
                "reason": "all stage bodies run on a row held in shared "
                          "memory: " + " >> ".join(str(h) for h in heads)}
    blockers = sorted({str(h) for h in heads if not _registered(h)
                       and h != "RectifyPool"})
    out = {"lowerable": False, "family": None,
           "reason": "unsupported stage(s): " + ", ".join(blockers)}
    named = {b: SUPPRESSED_STAGES[b] for b in blockers
             if b in SUPPRESSED_STAGES}
    if blockers and len(named) == len(blockers):
        out["suppressed"] = named
    return out


def _compile(statics):
    """[(masked, body)] per stage; raises ValueError when a stage has no
    registered body."""
    out = []
    for key in statics:
        body = _body(key)
        if body is None:
            raise ValueError(f"no elementwise body for stage {key!r}")
        out.append((_unwrap(key)[1], body))
    return out


def _f32(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def _scalar(value) -> float:
    """A scalar parameter rounded to float32, as JAX casts it to the
    input's type."""
    if isinstance(value, torch.Tensor):
        value = value.item()
    return float(np.float32(value))


def _operands(body: _Body, params, device):
    """(vectors flattened, 0-d scalars) of one stage, in float32."""
    params = tuple(params)
    vecs = tuple(_f32(p, device).reshape(-1) for p in params[:body.vectors])
    scal = tuple(_f32(p, device).reshape(())
                 for p in params[body.vectors:body.vectors + body.scalars])
    return vecs, scal


def elementwise_chain_reference(statics, params, x: torch.Tensor,
                                mask: Optional[torch.Tensor] = None):
    """The plain version: the stage bodies applied one after another.
    ``params``: one tuple per stage; ``mask``: (n,) valid rows or None.
    A masked stage multiplies its rows by the mask, as JAX re-zeroes
    padded rows at the stage's place in the chain."""
    m = None if mask is None else _f32(mask, x.device).reshape(-1)
    for (masked, body), p in zip(_compile(statics), params):
        vecs, scal = _operands(body, p, x.device)
        x = body.fn(x, vecs, scal)
        if masked and m is not None:
            x = x * m.reshape((-1,) + (1,) * (x.ndim - 1))
    return x


#: the most stages the kernel's table holds (``MAX_STAGES`` in
#: csrc/elementwise_chain.cu)
MAX_STAGES = 16


@dataclass
class ChainLayout:
    """What the CUDA kernel is told about a chain over rows of
    ``item_shape``: one table entry per stage (its code, the row length
    and last-axis length entering it, the offset of its vectors in
    ``packed``, its mask flag and two scalars), the two shared-memory row
    buffers' lengths in floats, and the output's item shape."""

    codes: list
    lens: list
    lasts: list
    offs: list
    masked: list
    s0: list
    s1: list
    packed: torch.Tensor
    buf0: int
    buf1: int
    out_shape: tuple

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.buf0 + self.buf1 + 32)


def chain_layout(statics, params, item_shape, device) -> ChainLayout:
    """Walk the chain over a row of ``item_shape``: the kernel's stage
    table, its packed vectors (on ``device``) and its buffer sizes. The
    GrayScaler on three channels writes a shorter row into the other
    buffer. Raises ValueError for a chain the kernel does not take."""
    stages = _compile(statics)
    params = tuple(params)
    if len(params) != len(stages):
        raise ValueError(f"elementwise_chain: {len(stages)} stages but "
                         f"{len(params)} parameter tuples")
    if len(stages) > MAX_STAGES:
        raise ValueError(f"elementwise_chain: {len(stages)} stages, the "
                         f"kernel takes at most {MAX_STAGES}")
    shape = tuple(item_shape)
    if not shape:
        raise ValueError("elementwise_chain: rows need at least one axis")
    table = {k: [] for k in ("codes", "lens", "lasts", "offs", "masked",
                             "s0", "s1")}
    vectors, off = [], 0
    sizes, cur = [math.prod(shape), 0], 0
    for (masked, body), p in zip(stages, params):
        p = tuple(p)
        vecs = tuple(_f32(q, device).reshape(-1) for q in p[:body.vectors])
        length, last = math.prod(shape), shape[-1]
        for v in vecs:
            if v.numel() != last:
                raise ValueError(
                    f"elementwise_chain: stage {body.code} has a vector of "
                    f"{v.numel()} values for a last axis of {last}")
        scalars = [_scalar(q) for q in
                   p[body.vectors:body.vectors + body.scalars]] + [0.0, 0.0]
        for name, value in (("codes", body.code), ("lens", length),
                            ("lasts", last), ("offs", off),
                            ("masked", int(masked)), ("s0", scalars[0]),
                            ("s1", scalars[1])):
            table[name].append(value)
        vectors.extend(vecs)
        off += len(vecs) * last
        shape = body.shape(shape)
        if body is _BODIES["GrayScaler"] and last == 3:
            cur = 1 - cur
            sizes[cur] = max(sizes[cur], math.prod(shape))
    packed = (torch.cat(vectors).contiguous() if vectors else
              torch.empty(0, dtype=torch.float32, device=device))
    buf0, buf1 = (-(-size // 4) * 4 for size in sizes)
    layout = ChainLayout(packed=packed, buf0=buf0, buf1=buf1,
                         out_shape=shape, **table)
    if layout.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"elementwise_chain: a row needs "
                         f"{layout.smem_bytes} bytes of shared memory "
                         f"(limit {MAX_SMEM_BYTES})")
    return layout


_IntArray = ctypes.POINTER(ctypes.c_int)
_FloatArray = ctypes.POINTER(ctypes.c_float)


def elementwise_chain(statics, params, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain in one pass. x (N, ...) f32 → (N, ...) f32. CUDA tensors
    run the kernel in ``csrc/elementwise_chain.cu``; CPU tensors run
    `elementwise_chain_reference`."""
    if x.device.type == "cpu":
        return elementwise_chain_reference(statics, params, x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"elementwise_chain: unsupported device "
                         f"{x.device}")
    _check_cuda("elementwise_chain", x.device, x=x)
    n = x.shape[0]
    layout = chain_layout(statics, params, x.shape[1:], x.device)
    m = None
    if mask is not None:
        m = _f32(mask, x.device).reshape(-1).contiguous()
        if m.numel() != n:
            raise ValueError("elementwise_chain: mask must be (N,)")
    out = torch.empty((n,) + layout.out_shape, dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    lib = _build.load("elementwise_chain")
    if lib.keystone_elementwise_chain_max_stages() != MAX_STAGES:
        raise RuntimeError("elementwise_chain: the kernel's stage table "
                           "and MAX_STAGES disagree")
    fn = lib.keystone_elementwise_chain
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [_IntArray] * 5 + [_FloatArray] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    k = len(layout.codes)

    def ints(values):
        return (ctypes.c_int * k)(*values)

    def floats(values):
        return (ctypes.c_float * k)(*values)

    rc = fn(x.data_ptr(), None if m is None else m.data_ptr(),
            layout.packed.data_ptr() if layout.packed.numel() else None,
            out.data_ptr(), n, math.prod(x.shape[1:]),
            math.prod(layout.out_shape), layout.buf0, layout.buf1, k,
            ints(layout.codes), ints(layout.lens), ints(layout.lasts),
            ints(layout.offs), ints(layout.masked), floats(layout.s0),
            floats(layout.s1), _stream(x.device))
    _raise_on_error(lib, "elementwise_chain", rc)
    elementwise_chain.launches += 1
    return out


elementwise_chain.launches = 0


def build_chain_fn(statics, family: Optional[str] = None):
    """A ``fn(params, xb, mb)`` that runs the sub-trail ``statics`` in
    one kernel launch, or None when it matches no family or ``family``
    (from a plan tag) disagrees with the matcher: a stale tag is never
    lowered wrongly."""
    statics = tuple(statics)
    verdict = lowerability(statics)
    if not verdict["lowerable"]:
        return None
    if family is not None and family != verdict["family"]:
        return None
    if verdict["family"] == "rectify_pool_vectorize":
        inner, _ = _unwrap(statics[0])
        _, alpha, max_val, pool, stride = inner[:5]

        def fn(ps, xb, mb):
            return rectify_pool_vectorize(xb, alpha, max_val, pool, stride)

        return fn

    def fn(ps, xb, mb):
        return elementwise_chain(statics, ps, xb, mb)

    return fn
