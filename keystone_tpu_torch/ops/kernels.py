"""The kernels' plain PyTorch versions, CUDA wrappers, and launch
counters.

Counterpart of `keystone_tpu/ops/pallas_kernels.py` (the fused
conv+rectify+pool kernel, `:591-659`, the rectify+pool kernel,
`:132-159`, and the RBF block, `:183-246`) and of the
`rectify_pool_vectorize` family of `keystone_tpu/ops/chain_kernels.py`
(`:346-381`). The elementwise chain kernel is in `chain_kernels.py`.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it launches the hand-written kernel (`csrc/`, built at first
use by `_build`) or raises: there is no fallback. A meta tensor (the
static analyzer's, `ops/meta.py`) gets an empty meta result of the
output's shape, no launch, and the kernel's FLOPs and bytes reported to
the analyzer's cost collector. Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``, that grows
by one per kernel launch and by nothing else. One `rbf_block` call
launches three kernels: the split prepass on X and on Yb, counted in
``rbf_split.launches``, and the product, counted in
``rbf_block.launches``.

Counts go through `tally` (`telemetry/metrics.py`, which the registry's
counters share). While a thread runs inside `tallied(sink)` (a chain
warmed up or captured into a CUDA graph), its counts go into ``sink``
instead, and the graph adds them to the counters at each replay
(`utils/graphs.py`): a replay launches what the capture recorded.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..telemetry.metrics import tally
from . import _build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rectify_pool_reference(x, alpha: float, max_val: float, pool: int,
                           stride: int) -> torch.Tensor:
    """SymmetricRectifier >> Pooler(sum) as the unfused stages compute
    them. x: (N, H, W, K) → (N, gy, gx, 2K)."""
    cat = torch.cat([torch.clamp(x - alpha, min=max_val),
                     torch.clamp(-x - alpha, min=max_val)], dim=-1)
    pooled = F.avg_pool2d(cat.permute(0, 3, 1, 2), pool, stride,
                          divisor_override=1)
    return pooled.permute(0, 2, 3, 1).contiguous()


def rectify_pool_vectorize_reference(x, alpha: float, max_val: float,
                                     pool: int, stride: int) -> torch.Tensor:
    """SymmetricRectifier >> Pooler(sum) >> ImageVectorizer.
    (N, H, W, K) → (N, gy·gx·2K)."""
    y = rectify_pool_reference(x, alpha, max_val, pool, stride)
    return y.reshape(y.shape[0], -1)


def folded_conv_reference(images, kernel_hwio, colsum, bias,
                          normalize: bool) -> torch.Tensor:
    """The folded conv in float32: the filter bank with the whitening
    folded in, the patch-mean subtraction as a rank-1 correction through
    a uniform conv, plus the bias. images (N,H,W,C), kernel (P,P,C,K) →
    (N, H−P+1, W−P+1, K)."""
    x = images.permute(0, 3, 1, 2)
    out = F.conv2d(x, kernel_hwio.permute(3, 2, 0, 1))
    if normalize:
        p, c = kernel_hwio.shape[0], kernel_hwio.shape[2]
        ones = torch.full((1, c, p, p), 1.0 / (p * p * c),
                          dtype=images.dtype, device=images.device)
        out = out - F.conv2d(x, ones) * colsum[:, None, None]
    out = out + bias[:, None, None]
    return out.permute(0, 2, 3, 1)


def conv_rectify_pool_reference(images, kernel_hwio, colsum, bias,
                                alpha: float, max_val: float, pool: int,
                                stride: int, normalize: bool) -> torch.Tensor:
    """Convolver >> SymmetricRectifier >> Pooler(sum), unfused, in fp32."""
    out = folded_conv_reference(images, kernel_hwio, colsum, bias, normalize)
    return rectify_pool_reference(out, alpha, max_val, pool, stride)


def rbf_block_reference(X, Yb, gamma: float) -> torch.Tensor:
    """exp(−γ·max(‖x‖² − 2x·y + ‖y‖², 0)) for every row x of X (m,d) and
    y of Yb (n,d), in float32 (`pallas_kernels.py:183-191`); on the card
    the product runs in true fp32 (TF32 off, `device.py`)."""
    d2 = ((X * X).sum(dim=1, keepdim=True) - 2.0 * (X @ Yb.T)
          + (Yb * Yb).sum(dim=1))
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


#: the bits a TF32 tensor core keeps of an fp32 value: sign, exponent and
#: the top 10 of the 23 mantissa bits (0xffffe000 as int32)
TF32_MASK = -8192


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = x truncated to TF32 (its low 13 mantissa bits
    cleared, as a TF32 tensor core reads x) and lo = x − hi, both exact in
    float32: the split of the RBF kernel's prepass (``csrc/rbf_block.cu``).
    """
    hi = (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, x - hi


def rbf_block_3xtf32_emulated(X, Yb, gamma: float,
                              products: int = 3) -> torch.Tensor:
    """Plain emulation of the RBF kernel's product, for the tests:
    ``products=3`` sums hi·loᵀ + lo·hiᵀ, then hi·hiᵀ,
    with lo truncated to TF32 as the tensor cores read it (lo·lo dropped);
    ``products=1`` takes hi·hiᵀ alone (one TF32 product). The products
    are float32 matmuls; the norms come from the unsplit rows, as in the
    kernel's prepass."""
    if products not in (1, 3):
        raise ValueError(f"products must be 1 or 3, not {products}")
    xh, xl = tf32_split(X)
    yh, yl = tf32_split(Yb)
    acc = xh @ yh.T
    if products == 3:
        acc = (xh @ tf32_split(yl)[0].T + tf32_split(xl)[0] @ yh.T) + acc
    d2 = ((X * X).sum(dim=1, keepdim=True) - 2.0 * acc
          + (Yb * Yb).sum(dim=1))
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def hwio_to_cmajor(kernel_hwio: torch.Tensor) -> torch.Tensor:
    """(P,P,C,K) → the channel-major (C·P·P, K) layout the fused kernel
    takes (the order of `conv_general_dilated_patches`)."""
    return kernel_hwio.permute(2, 0, 1, 3).reshape(-1, kernel_hwio.shape[3])


def cmajor_to_hwio(g_cmajor: torch.Tensor, patch: int) -> torch.Tensor:
    c = g_cmajor.shape[0] // (patch * patch)
    return g_cmajor.reshape(c, patch, patch, -1).permute(1, 2, 0, 3)


def pooled_grid(h: int, w: int, pool: int, stride: int):
    """(gy, gx): the number of pool windows along each axis."""
    return (h - pool) // stride + 1, (w - pool) // stride + 1


def pool_window_ranges(n_pos: int, pool: int, stride: int):
    """For each index 0..n_pos−1 along one axis, the first and last pool
    window that covers it: window i covers [i·stride, i·stride + pool).
    Two int64 tensors; first > last where no window covers the index."""
    pos = torch.arange(n_pos)
    n_win = (n_pos - pool) // stride + 1
    first = torch.clamp(-((pool - 1 - pos) // stride), min=0)
    last = torch.clamp(pos // stride, max=n_win - 1)
    return first, last


#: positions that share one class word in the fused conv kernel's plan
CONV_GROUP_ROWS = 8
#: largest window index a class word holds (7 bits a field)
CONV_MAX_WINDOWS = 127
#: set in a class word whose positions include padding
CONV_PAD_FLAG = 1 << 28


def conv_row_plan(pos_h: int, pos_w: int, pool: int, stride: int):
    """The fused conv kernel's plan of positions over a (pos_h, pos_w)
    grid of conv positions: (row_pos, group_windows), int32 tensors.

    ``row_pos`` lists the positions (y·pos_w + x) that lie in at least
    one pool window, grouped by their class, the window range they fall
    in along each axis, in the raster order of each class's first
    position; each class is padded with −1 to a multiple of
    `CONV_GROUP_ROWS`. ``group_windows[i]`` packs the class of entries
    8i..8i+7 as ``wy0 | wy1 << 7 | wx0 << 14 | wx1 << 21`` (first and last
    window along y and x), with `CONV_PAD_FLAG` where they include
    padding.
    """
    fy, ly = pool_window_ranges(pos_h, pool, stride)
    fx, lx = pool_window_ranges(pos_w, pool, stride)
    classes = {}
    for y in range(pos_h):
        for x in range(pos_w):
            key = (int(fy[y]), int(ly[y]), int(fx[x]), int(lx[x]))
            if key[0] <= key[1] and key[2] <= key[3]:
                classes.setdefault(key, []).append(y * pos_w + x)
    rows, groups = [], []
    for (wy0, wy1, wx0, wx1), members in classes.items():
        pad = -len(members) % CONV_GROUP_ROWS
        rows += members + [-1] * pad
        word = wy0 | wy1 << 7 | wx0 << 14 | wx1 << 21
        groups += [word] * (len(members) // CONV_GROUP_ROWS)
        if pad:
            groups.append(word | CONV_PAD_FLAG)
    return (torch.tensor(rows, dtype=torch.int32),
            torch.tensor(groups, dtype=torch.int32))


_row_plans = {}


def _device_row_plan(pos_h, pos_w, pool, stride, device):
    key = (pos_h, pos_w, pool, stride, device)
    if key not in _row_plans:
        _row_plans[key] = tuple(
            t.to(device) for t in conv_row_plan(pos_h, pos_w, pool, stride))
    return _row_plans[key]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

#: largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448

#: filters per M tile of the fused conv kernel
CONV_FILTER_TILE = 64


def conv_filter_chunk(k: int, smem_of, limit: int = MAX_SMEM_BYTES) -> int:
    """Filters per launch of the fused conv kernel, whose block holds its
    share of the bank in shared memory: ``k`` where ``smem_of(k)`` bytes
    fit ``limit``, else the largest multiple of `CONV_FILTER_TILE` that
    fits; 0 where not even one tile does."""
    kc = k
    while kc > 0 and smem_of(kc) > limit:
        kc = (kc - 1) // CONV_FILTER_TILE * CONV_FILTER_TILE
    return kc


def _check_cuda(name: str, device: torch.device,
                dtypes=(torch.float32,), **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} must be "
                            f"{' or '.join(map(str, dtypes))}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_out(name: str, out: torch.Tensor, shape, device) -> None:
    """``out`` can take a result of ``shape``: as many f32 elements,
    contiguous, on ``device``."""
    if out.device != device or out.dtype != torch.float32 \
            or not out.is_contiguous() or out.numel() != math.prod(shape):
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} cannot take a contiguous float32 "
                         f"result of shape {tuple(shape)} on {device}")


def _raise_on_error(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.keystone_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def conv_rectify_pool(images, g_cmajor, colsum, bias, alpha: float,
                      max_val: float, pool: int, stride: int,
                      normalize: bool, patch: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused conv + patch-mean correction + two-sided rectify + sum pool.

    images (N,H,W,C) f32 or bf16 (a bf16 storage trail of the precision
    planner: the kernel reads the bf16 values it would round the f32
    ones to, in the same build), g_cmajor (C·P·P, K) f32 in channel-major order,
    colsum and bias (K,) f32 → (N, gy, gx, 2K) f32. CUDA tensors run the
    kernel in ``csrc/conv_rectify_pool.cu`` (bf16 operands on the tensor
    cores, fp32 sums) over the row plan of `conv_row_plan`; CPU tensors
    run `conv_rectify_pool_reference`. A bank too large for one block's
    shared memory runs as one launch per chunk of `conv_filter_chunk`
    filters. With ``out``, a contiguous f32 tensor of N·gy·gx·2K
    elements on the images' device (rows of a larger feature matrix, for
    one), the result is written there and ``out`` is returned."""
    n, h, w, c = images.shape
    k = g_cmajor.shape[1]
    in_bf16 = images.dtype == torch.bfloat16
    if images.device.type == "cpu":
        y = conv_rectify_pool_reference(
            images.float() if in_bf16 else images,
            cmajor_to_hwio(g_cmajor, patch), colsum, bias, alpha,
            max_val, pool, stride, normalize)
        if out is None:
            return y
        _check_out("conv_rectify_pool", out, y.shape, images.device)
        return out.copy_(y.reshape(out.shape))
    if images.device.type == "meta":
        return _conv_rectify_pool_meta(images, k, patch, pool, stride, out,
                                       2 if in_bf16 else 4)
    if images.device.type != "cuda":
        raise ValueError(f"conv_rectify_pool: unsupported device "
                         f"{images.device}")
    _check_cuda("conv_rectify_pool", images.device, g_cmajor=g_cmajor,
                colsum=colsum, bias=bias)
    _check_cuda("conv_rectify_pool", images.device,
                dtypes=(torch.float32, torch.bfloat16), images=images)
    if g_cmajor.shape[0] != c * patch * patch:
        raise ValueError(f"conv_rectify_pool: g_cmajor has "
                         f"{g_cmajor.shape[0]} rows, expected C·P·P = "
                         f"{c * patch * patch}")
    if colsum.shape != (k,) or bias.shape != (k,):
        raise ValueError("conv_rectify_pool: colsum and bias must be (K,)")
    pos_h, pos_w = h - patch + 1, w - patch + 1
    gy, gx = pooled_grid(pos_h, pos_w, pool, stride)
    if gy < 1 or gx < 1:
        raise ValueError("conv_rectify_pool: pool window exceeds the "
                         "conv output")
    if max(gy, gx) > CONV_MAX_WINDOWS + 1:
        raise ValueError(f"conv_rectify_pool: {gy}x{gx} pool windows; the "
                         f"row plan packs window indices in 7 bits")
    row_pos, group_windows = _device_row_plan(pos_h, pos_w, pool, stride,
                                              images.device)
    lib = _build.load("conv_rectify_pool")
    fn = lib.keystone_conv_rectify_pool
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _F, _F, _I, _I, _P]
    fn.restype = _I
    smem_fn = lib.keystone_conv_rectify_pool_smem
    smem_fn.argtypes = [_I] * 7
    smem_fn.restype = ctypes.c_size_t
    rows = row_pos.numel()
    kc = conv_filter_chunk(
        k, lambda f: smem_fn(h, w, c, patch, f, gy * gx, rows))
    if kc == 0:
        smem = smem_fn(h, w, c, patch, min(k, CONV_FILTER_TILE), gy * gx,
                       rows)
        raise ValueError(f"conv_rectify_pool: a block would need {smem} "
                         f"bytes of shared memory (limit {MAX_SMEM_BYTES})")
    if out is None:
        out = torch.empty((n, gy, gx, 2 * k), dtype=torch.float32,
                          device=images.device)
    else:
        _check_out("conv_rectify_pool", out, (n, gy, gx, 2 * k),
                   images.device)
    if n == 0:
        return out
    # chunk f0..f0+kc−1 of the bank: offset the per-filter pointers
    for f0 in range(0, k, kc):
        rc = fn(images.data_ptr(), g_cmajor.data_ptr() + 4 * f0,
                colsum.data_ptr() + 4 * f0, bias.data_ptr() + 4 * f0,
                row_pos.data_ptr(), group_windows.data_ptr(),
                out.data_ptr() + 4 * f0, n, h, w, c, min(kc, k - f0), k,
                patch, pool, stride, rows, float(alpha), float(max_val),
                int(bool(normalize)), int(in_bf16), _stream(images.device))
        _raise_on_error(lib, "conv_rectify_pool", rc)
        tally(conv_rectify_pool)
    return out


conv_rectify_pool.launches = 0


def _conv_rectify_pool_meta(images, k: int, patch: int, pool: int,
                            stride: int, out, in_itemsize: int = 4):
    """K1's meta branch (`ops/meta.py`): the output's shape, and the
    conv's products at the positions some pool window covers, against
    each input read once and the output written once."""
    n, h, w, c = images.shape
    ph, pw = h - patch + 1, w - patch + 1
    gy, gx = pooled_grid(ph, pw, pool, stride)
    cy = min(ph, (gy - 1) * stride + pool)
    cx = min(pw, (gx - 1) * stride + pool)
    meta.report("conv_rectify_pool",
                2.0 * n * cy * cx * c * patch * patch * k,
                in_itemsize * n * h * w * c
                + 4.0 * (c * patch * patch * k + 2 * k
                         + n * gy * gx * 2 * k))
    return out if out is not None else meta.empty((n, gy, gx, 2 * k))


def rectify_pool(x, alpha: float, max_val: float, pool: int,
                 stride: int) -> torch.Tensor:
    """Two-sided rectify + sum pool. x (N,H,W,K) f32 → (N,gy,gx,2K) f32.
    CUDA tensors run the kernel in ``csrc/rectify_pool.cu``; CPU tensors
    run `rectify_pool_reference`."""
    if x.device.type == "cpu":
        return rectify_pool_reference(x, alpha, max_val, pool, stride)
    if x.device.type == "meta":
        # K2's meta branch (`ops/meta.py`): six operations a window
        # value against each input read and the output written once
        n, h, w, k = x.shape
        gy, gx = pooled_grid(h, w, pool, stride)
        meta.report("rectify_pool", 6.0 * n * gy * gx * pool * pool * k,
                    4.0 * (n * h * w * k + n * gy * gx * 2 * k))
        return meta.empty((n, gy, gx, 2 * k))
    if x.device.type != "cuda":
        raise ValueError(f"rectify_pool: unsupported device {x.device}")
    _check_cuda("rectify_pool", x.device, x=x)
    n, h, w, k = x.shape
    gy, gx = pooled_grid(h, w, pool, stride)
    if gy < 1 or gx < 1:
        raise ValueError("rectify_pool: pool window exceeds the input")
    lib = _build.load("rectify_pool")
    fn = lib.keystone_rectify_pool
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
    fn.restype = _I
    out = torch.empty((n, gy, gx, 2 * k), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    rc = fn(x.data_ptr(), out.data_ptr(), n, h, w, k, pool, stride,
            float(alpha), float(max_val), _stream(x.device))
    _raise_on_error(lib, "rectify_pool", rc)
    tally(rectify_pool)
    return out


rectify_pool.launches = 0


def rectify_pool_vectorize(x, alpha: float, max_val: float, pool: int,
                           stride: int) -> torch.Tensor:
    """`rectify_pool` followed by a flatten to (N, gy·gx·2K): the same
    kernel, and a view of its output. Its own count holds the launches
    made through it."""
    y = rectify_pool(x, alpha, max_val, pool, stride)
    if x.device.type == "cuda" and x.shape[0] > 0:
        tally(rectify_pool_vectorize)
    return y.reshape(y.shape[0], -1)


rectify_pool_vectorize.launches = 0


def _padded_depth(d: int) -> int:
    """Row stride, in floats, of the RBF prepass's outputs where it writes
    hi: d rounded up to 4 floats, as TMA needs 16-byte row strides."""
    return (d + 3) // 4 * 4


def _rbf_raw_hi(X) -> bool:
    """Whether X can serve as its own hi part on the card: rows of whole
    16-byte units at a 16-byte aligned base, as TMA reads them."""
    return X.shape[-1] % 4 == 0 and X.data_ptr() % 16 == 0


def rbf_split(X) -> tuple:
    """The RBF kernel's prepass on its own, as `rbf_block` runs it on
    each operand: (hi, lo, x2) for the rows of X (m,d) f32, hi and lo as
    `tf32_split` gives them and x2 the rows' squared norms in float32.
    CUDA tensors run ``keystone_rbf_split`` of ``csrc/rbf_block.cu``,
    whose hi is None where X serves as its own hi part; CPU tensors run
    `tf32_split` and a torch sum."""
    if X.device.type == "cpu":
        hi, lo = tf32_split(X)
        return hi, lo, (X * X).sum(dim=1)
    if X.device.type == "meta":
        m, d = X.shape
        meta.report("rbf_split", 3.0 * m * d, 4.0 * (m * d + 2 * m * d + m))
        return meta.empty((m, d)), meta.empty((m, d)), meta.empty((m,))
    if X.device.type != "cuda":
        raise ValueError(f"rbf_split: unsupported device {X.device}")
    _check_cuda("rbf_split", X.device, X=X)
    if X.ndim != 2:
        raise ValueError(f"rbf_split: X {tuple(X.shape)} must be (m,d)")
    m, d = X.shape
    raw = _rbf_raw_hi(X)
    ld = d if raw else _padded_depth(d)
    lo = torch.empty((m, ld), dtype=torch.float32, device=X.device)
    hi = None if raw else torch.empty_like(lo)
    x2 = torch.empty((m,), dtype=torch.float32, device=X.device)
    if m > 0:
        lib = _build.load("rbf_block")
        fn = lib.keystone_rbf_split
        fn.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
        fn.restype = _I
        rc = fn(X.data_ptr(), m, d, ld, lo.data_ptr(),
                None if hi is None else hi.data_ptr(), x2.data_ptr(),
                _stream(X.device))
        _raise_on_error(lib, "rbf_split", rc)
        tally(rbf_split)
    return None if hi is None else hi[:, :d], lo[:, :d], x2


rbf_split.launches = 0


def rbf_block(X, Yb, gamma: float) -> torch.Tensor:
    """RBF kernel block. X (m,d), Yb (n,d) f32 → (m,n) f32. CUDA tensors
    run ``csrc/rbf_block.cu``: a prepass that splits the rows into TF32
    hi and lo parts and takes their squared norms (`rbf_split`), then
    three TF32 tensor-core products a step (hi·lo, lo·hi, hi·hi) summed
    in fp32, with the epilogue before the write. CPU tensors run
    `rbf_block_reference`. Operands that can serve as their own hi part
    (`_rbf_raw_hi`) are read as such; otherwise the prepass writes hi
    too, at a row stride of whole 16-byte units."""
    if X.device.type == "cpu":
        return rbf_block_reference(X, Yb, gamma)
    if X.device.type == "meta":
        # K5's meta branch (`ops/meta.py`): three TF32 products of
        # 2·m·n·d operations against X and Yb read and the block written
        m, d = X.shape
        n = Yb.shape[0]
        meta.report("rbf_block", 3 * 2.0 * m * n * d,
                    4.0 * (m * d + n * d + m * n))
        return meta.empty((m, n))
    if X.device.type != "cuda":
        raise ValueError(f"rbf_block: unsupported device {X.device}")
    return _rbf_block_cuda(X, Yb, gamma,
                           write_hi=not (_rbf_raw_hi(X) and _rbf_raw_hi(Yb)))


def _rbf_block_cuda(X, Yb, gamma: float, write_hi: bool) -> torch.Tensor:
    """`rbf_block` on the card, with the hi parts written by the prepass
    (``write_hi``) or read from X and Yb themselves."""
    _check_cuda("rbf_block", X.device, X=X, Yb=Yb)
    if X.ndim != 2 or Yb.ndim != 2 or X.shape[1] != Yb.shape[1]:
        raise ValueError(f"rbf_block: X {tuple(X.shape)} and Yb "
                         f"{tuple(Yb.shape)} must be (m,d) and (n,d)")
    m, d = X.shape
    n = Yb.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=X.device)
    if m == 0 or n == 0:
        return out
    if d == 0:
        raise ValueError("rbf_block: rows of length 0")
    ld = _padded_depth(d) if write_hi else d
    lo = torch.empty((m + n, ld), dtype=torch.float32, device=X.device)
    hi = torch.empty_like(lo) if write_hi else None
    norms = torch.empty((m + n,), dtype=torch.float32, device=X.device)
    lib = _build.load("rbf_block")
    fn = lib.keystone_rbf_block
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
    fn.restype = _I
    rc = fn(X.data_ptr(), Yb.data_ptr(), lo.data_ptr(),
            None if hi is None else hi.data_ptr(), norms.data_ptr(),
            out.data_ptr(), m, n, d, ld, float(gamma), _stream(X.device))
    _raise_on_error(lib, "rbf_block", rc)
    tally(rbf_split, n=2)  # the prepass on X, then on Yb
    tally(rbf_block)  # the product
    return out


rbf_block.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    from .chain_kernels import elementwise_chain

    for wrapper in (conv_rectify_pool, rectify_pool, rectify_pool_vectorize,
                    rbf_block, rbf_split, elementwise_chain):
        wrapper.launches = 0
