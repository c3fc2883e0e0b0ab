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
no counterpart: `chain_launch_config` sizes the CUDA kernel's row slot
in shared memory, and raises when a row does not fit. A row too long for
it is cut into segments along its leading axes where every stage acts
within a segment (`row_segments`: no vector parameter, no reduction
across the row), so the gray chain runs on real VOC images (a 500x333
image is 333 rows of 500 pixels); the JAX kernel's VMEM block takes
such a row whole. A `ChainPlan` holds what a chain's launches share, so
that a microbatch costs one C call.
"""

from __future__ import annotations

import ctypes
import math
import threading
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..telemetry.metrics import tally
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

#: the one stage that reduces across a row
_NORMALIZE_ROWS = _BODIES["NormalizeRows"].code


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

#: threads of a chain kernel block (``THREADS``)
CHAIN_THREADS = 128
#: shared memory ahead of the kernel's row slot (``FIXED_SMEM``): the
#: slot's barrier (16 bytes), 32 warp sums, and the norm denominators of
#: each row group (a warp at most)
CHAIN_FIXED_SMEM = 16 + 4 * 32 + 4 * (CHAIN_THREADS // 32) * MAX_STAGES
#: rows shorter than this share a step with their neighbours, a warp a
#: row, so that a step moves at least `CHAIN_STEP_BYTES`, in a multiple
#: of the block's warps
CHAIN_SHORT_ROW_BYTES = 4096
CHAIN_STEP_BYTES = 16384


@dataclass(frozen=True)
class ChainLaunch:
    """How the chain kernel walks rows of ``in_len`` floats: ``rows`` per
    step, ``group`` threads per row (the whole block on one row, or a
    warp a row where a step holds several, as many for each warp), one
    slot of ``slot_bytes``
    (the step's bytes, rounded up to 16, plus 16 for an unaligned start)
    and ``smem_bytes`` of shared memory in all."""

    rows: int
    group: int
    slot_bytes: int
    smem_bytes: int


def chain_launch_config(in_len: int) -> ChainLaunch:
    """The launch of the chain kernel over rows of ``in_len`` floats;
    raises ValueError where a step does not fit a block's shared memory.

    A block holds one step at a time: the SM's other resident blocks keep
    their copies in flight while a block computes. A ring of two or three
    slots a block measured slower on the card at LinearPixels' rows
    (fewer resident blocks, or more copies queued at a launch's start;
    PERF.md)."""
    row_bytes = 4 * in_len
    if row_bytes < 4:
        raise ValueError("elementwise_chain: rows need at least one element")
    warps = CHAIN_THREADS // 32
    rows = (1 if row_bytes >= CHAIN_SHORT_ROW_BYTES
            else -(-CHAIN_STEP_BYTES // (warps * row_bytes)) * warps)
    slot = -(-rows * row_bytes // 16) * 16 + 16
    smem = CHAIN_FIXED_SMEM + slot
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"elementwise_chain: a row of {row_bytes} bytes "
                         f"needs {smem} bytes of shared memory (limit "
                         f"{MAX_SMEM_BYTES})")
    return ChainLaunch(rows=rows, group=CHAIN_THREADS if rows == 1 else 32,
                       slot_bytes=slot, smem_bytes=smem)


@dataclass
class ChainLayout:
    """What the CUDA kernel is told about a chain over rows of
    ``item_shape``: one table entry per stage (its code, the row length
    and last-axis length entering it, the offset of its vectors in
    ``packed``, its mask flag and two scalars), the output's item shape,
    the launch (`chain_launch_config`), and the ``segments`` an item is
    cut into (the kernel's rows; the table describes one segment)."""

    codes: list
    lens: list
    lasts: list
    offs: list
    masked: list
    s0: list
    s1: list
    packed: torch.Tensor
    out_shape: tuple
    launch: ChainLaunch
    segments: int = 1


def row_segments(stages, item_shape) -> int:
    """The segments an item of ``item_shape`` is cut into along its
    leading axes: 1 where the whole row fits a block's shared memory,
    else the fewest leading axes' product whose remaining row fits,
    provided every stage acts within a segment (no vector parameter, no
    reduction across the row). Raises ValueError where none fits."""
    shape = tuple(item_shape)
    try:
        chain_launch_config(math.prod(shape))
        return 1
    except ValueError:
        local = all(body.vectors == 0 and body.code != _NORMALIZE_ROWS
                    for _, body in stages)
        if not local:
            raise
    for k in range(1, len(shape)):
        try:
            chain_launch_config(math.prod(shape[k:]))
        except ValueError:
            continue
        return math.prod(shape[:k])
    raise ValueError(f"elementwise_chain: no segment of a {shape} row fits "
                     f"shared memory")


def chain_layout(statics, params, item_shape, device) -> ChainLayout:
    """Walk the chain over a row of ``item_shape``: the kernel's stage
    table, its packed vectors (on ``device``) and its launch. Raises
    ValueError for a chain the kernel does not take."""
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
    out_shape = shape
    for _, body in stages:
        out_shape = body.shape(out_shape)
    segments = row_segments(stages, shape)
    if segments > 1:  # the table describes one segment: a kernel row
        k = next(k for k in range(1, len(shape))
                 if math.prod(shape[:k]) == segments)
        shape = shape[k:]
    table = {k: [] for k in ("codes", "lens", "lasts", "offs", "masked",
                             "s0", "s1")}
    vectors, off = [], 0
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
    packed = (torch.cat(vectors).contiguous() if vectors else
              torch.empty(0, dtype=torch.float32, device=device))
    return ChainLayout(packed=packed, out_shape=out_shape,
                       launch=chain_launch_config(table["lens"][0]),
                       segments=segments, **table)


_IntArray = ctypes.POINTER(ctypes.c_int)
_FloatArray = ctypes.POINTER(ctypes.c_float)
_VoidP = ctypes.c_void_p


def _library():
    """The chain kernel's library, its entry points typed once."""
    lib = _build.load("elementwise_chain")
    if not getattr(lib, "chain_typed", False):
        if lib.keystone_elementwise_chain_max_stages() != MAX_STAGES:
            raise RuntimeError("elementwise_chain: the kernel's stage table "
                               "and MAX_STAGES disagree")
        if lib.keystone_elementwise_chain_fixed_smem() != CHAIN_FIXED_SMEM:
            raise RuntimeError("elementwise_chain: the kernel's shared "
                               "memory layout and CHAIN_FIXED_SMEM disagree")
        lib.keystone_elementwise_chain_plan.argtypes = (
            [_VoidP] + [ctypes.c_int] * 7 + [_IntArray] * 4
            + [_FloatArray] * 2 + [ctypes.POINTER(_VoidP),
                                   ctypes.POINTER(ctypes.c_int)])
        lib.keystone_elementwise_chain_plan.restype = ctypes.c_int
        lib.keystone_elementwise_chain_run.argtypes = [
            _VoidP, _VoidP, _VoidP, _VoidP, ctypes.c_longlong, _VoidP]
        lib.keystone_elementwise_chain_run.restype = ctypes.c_int
        lib.keystone_elementwise_chain_free.argtypes = [_VoidP]
        lib.keystone_elementwise_chain_free.restype = None
        lib.chain_typed = True
    return lib


class ChainPlan:
    """One chain over rows of one item shape on one device, planned once
    and launched for every microbatch.

    The plan holds what does not change between launches: the stage
    table and packed vectors on the device and the scalars as host
    floats (`chain_layout`), and, on a CUDA device, the C side's plan
    (the table by value, the grid, the kernel's shared-memory attribute
    set once). A launch is then one C call with the pointers, the row
    count and the stream: no device sync, no upload, no walk of the
    chain. The parameters are read once, here: as in the JAX package,
    whose arrays are immutable, a chain's parameters are fixed once its
    stages are fitted. On the CPU a call runs
    `elementwise_chain_reference`."""

    def __init__(self, statics, params, item_shape, device):
        self.statics = tuple(statics)
        self.params = tuple(tuple(p) for p in params)
        self.item_shape = tuple(item_shape)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"elementwise_chain: unsupported device "
                             f"{self.device}")
        self.layout = chain_layout(self.statics, self.params,
                                   self.item_shape, self.device)
        self.out_shape = self.layout.out_shape
        self.segments = self.layout.segments
        self.in_len = math.prod(self.item_shape)
        self.grid = None
        self._handle = None
        if self.device.type == "cuda":
            self._plan_kernel()

    def _plan_kernel(self):
        lay, launch = self.layout, self.layout.launch
        k = len(lay.codes)

        def ints(values):
            return (ctypes.c_int * k)(*values)

        def floats(values):
            return (ctypes.c_float * k)(*values)

        lib = _library()
        handle, grid = _VoidP(), ctypes.c_int()
        with torch.cuda.device(self.device):
            rc = lib.keystone_elementwise_chain_plan(
                lay.packed.data_ptr() if lay.packed.numel() else None,
                self.in_len // self.segments,
                math.prod(self.out_shape) // self.segments, launch.rows,
                launch.group, launch.slot_bytes, launch.smem_bytes, k,
                ints(lay.codes), ints(lay.lasts), ints(lay.offs),
                ints(lay.masked), floats(lay.s0), floats(lay.s1),
                ctypes.byref(handle), ctypes.byref(grid))
        _raise_on_error(lib, "elementwise_chain plan", rc)
        self._lib = lib
        self._run = lib.keystone_elementwise_chain_run
        self._handle = handle.value
        self.grid = grid.value
        weakref.finalize(self, lib.keystone_elementwise_chain_free,
                         self._handle)

    def __call__(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chain over x (N, *item_shape) f32 → (N, *out_shape) f32,
        written into ``out`` where given (a contiguous tensor of that
        shape, such as a slice of a larger result)."""
        n = x.shape[0]
        shape = (n,) + self.out_shape
        if tuple(x.shape[1:]) != self.item_shape:
            raise ValueError(f"elementwise_chain: rows of {tuple(x.shape[1:])}"
                             f", the plan is for {self.item_shape}")
        if x.device != self.device:
            raise ValueError(f"elementwise_chain: x is on {x.device}, the "
                             f"plan on {self.device}")
        if out is not None and (tuple(out.shape) != shape
                                or out.device != x.device):
            raise ValueError(f"elementwise_chain: out must be {shape} on "
                             f"{x.device}, not {tuple(out.shape)} on "
                             f"{out.device}")
        if self._handle is None:
            y = elementwise_chain_reference(self.statics, self.params, x,
                                            mask)
            return y if out is None else out.copy_(y)
        m = None
        if mask is not None:
            m = _f32(mask, x.device).reshape(-1)
            if m.numel() != n:
                raise ValueError("elementwise_chain: mask must be (N,)")
            m = m.repeat_interleave(self.segments).contiguous()
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=x.device)
        _check_cuda("elementwise_chain", x.device, x=x, out=out)
        if n == 0:
            return out
        rc = self._run(self._handle, x.data_ptr(),
                       None if m is None else m.data_ptr(), out.data_ptr(),
                       n * self.segments, _stream(x.device))
        if rc:
            _raise_on_error(self._lib, "elementwise_chain", rc)
        tally(elementwise_chain)
        return out


def elementwise_chain(statics, params, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain in one pass. x (N, ...) f32 → (N, ...) f32, written into
    ``out`` where given. Builds a `ChainPlan` for this call: CUDA tensors
    run the kernel in ``csrc/elementwise_chain.cu``; CPU tensors run
    `elementwise_chain_reference`. Its ``launches`` count every launch
    of the kernel, by a plan or through here."""
    return ChainPlan(statics, params, x.shape[1:], x.device)(x, mask, out)


elementwise_chain.launches = 0


def build_chain_fn(statics, params, family: Optional[str] = None):
    """A function that runs the sub-trail ``statics`` with its fitted
    ``params`` in one kernel launch, or None when it matches no family
    or ``family`` (from a plan tag) disagrees with the matcher: a stale
    tag is never lowered wrongly. The elementwise family's
    ``fn(xb, out=None)`` keeps one `ChainPlan` per item shape and device
    in ``fn.plans``, built at the first microbatch of that shape
    (``fn.plan_for(xb)``) and reused for every later one, and writes
    into ``out`` where given. The rectify+pool family's ``fn(xb)``
    returns a new tensor (``fn.plans`` is None)."""
    statics = tuple(statics)
    verdict = lowerability(statics)
    if not verdict["lowerable"]:
        return None
    if family is not None and family != verdict["family"]:
        return None
    if verdict["family"] == "rectify_pool_vectorize":
        inner, _ = _unwrap(statics[0])
        _, alpha, max_val, pool, stride = inner[:5]

        def fn(xb):
            return rectify_pool_vectorize(xb, alpha, max_val, pool, stride)

        fn.plans = None
        return fn

    plans = {}
    lock = threading.Lock()

    def plan_for(xb) -> ChainPlan:
        # built once under the lock: a plan is never replaced, since a
        # captured graph reads its buffers (`utils/graphs.py`)
        key = (tuple(xb.shape[1:]), xb.device)
        plan = plans.get(key)
        if plan is None:
            with lock:
                plan = plans.get(key)
                if plan is None:
                    plan = plans[key] = ChainPlan(statics, params, *key)
        return plan

    def fn(xb, out=None):
        return plan_for(xb)(xb, None, out)

    fn.plans, fn.plan_for = plans, plan_for
    return fn
