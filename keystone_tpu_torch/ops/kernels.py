"""The featurizer's kernels: plain PyTorch versions, CUDA wrappers, and
launch counters.

Counterpart of `keystone_tpu/ops/pallas_kernels.py` (the fused
conv+rectify+pool kernel, `:591-659`, and the rectify+pool kernel,
`:132-159`) and of the `rectify_pool_vectorize` family of
`keystone_tpu/ops/chain_kernels.py` (`:346-381`).

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it launches the hand-written kernel (`csrc/`, built at first
use by `_build`) or raises: there is no fallback. Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``, that grows
by one per kernel launch and by nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

#: largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on_error(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.keystone_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def conv_rectify_pool(images, g_cmajor, colsum, bias, alpha: float,
                      max_val: float, pool: int, stride: int,
                      normalize: bool, patch: int) -> torch.Tensor:
    """Fused conv + patch-mean correction + two-sided rectify + sum pool.

    images (N,H,W,C) f32, g_cmajor (C·P·P, K) f32 in channel-major order,
    colsum and bias (K,) f32 → (N, gy, gx, 2K) f32. CUDA tensors run the
    kernel in ``csrc/conv_rectify_pool.cu`` (bf16 operands, fp32 sums);
    CPU tensors run `conv_rectify_pool_reference`."""
    n, h, w, c = images.shape
    k = g_cmajor.shape[1]
    if images.device.type == "cpu":
        return conv_rectify_pool_reference(
            images, cmajor_to_hwio(g_cmajor, patch), colsum, bias, alpha,
            max_val, pool, stride, normalize)
    if images.device.type != "cuda":
        raise ValueError(f"conv_rectify_pool: unsupported device "
                         f"{images.device}")
    _check_cuda("conv_rectify_pool", images.device, images=images,
                g_cmajor=g_cmajor, colsum=colsum, bias=bias)
    if g_cmajor.shape[0] != c * patch * patch:
        raise ValueError(f"conv_rectify_pool: g_cmajor has "
                         f"{g_cmajor.shape[0]} rows, expected C·P·P = "
                         f"{c * patch * patch}")
    if colsum.shape != (k,) or bias.shape != (k,):
        raise ValueError("conv_rectify_pool: colsum and bias must be (K,)")
    gy, gx = pooled_grid(h - patch + 1, w - patch + 1, pool, stride)
    if gy < 1 or gx < 1:
        raise ValueError("conv_rectify_pool: pool window exceeds the "
                         "conv output")
    lib = _build.load("conv_rectify_pool")
    fn = lib.keystone_conv_rectify_pool
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                   _F, _I, _P]
    fn.restype = _I
    smem_fn = lib.keystone_conv_rectify_pool_smem
    smem_fn.argtypes = [_I] * 6
    smem_fn.restype = ctypes.c_size_t
    smem = smem_fn(h, w, c, patch, gy, gx)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv_rectify_pool: a block would need {smem} "
                         f"bytes of shared memory (limit {MAX_SMEM_BYTES})")
    out = torch.empty((n, gy, gx, 2 * k), dtype=torch.float32,
                      device=images.device)
    if n == 0:
        return out
    rc = fn(images.data_ptr(), g_cmajor.data_ptr(), colsum.data_ptr(),
            bias.data_ptr(), out.data_ptr(), n, h, w, c, k, patch, pool,
            stride, float(alpha), float(max_val), int(bool(normalize)),
            _stream(images.device))
    _raise_on_error(lib, "conv_rectify_pool", rc)
    conv_rectify_pool.launches += 1
    return out


conv_rectify_pool.launches = 0


def rectify_pool(x, alpha: float, max_val: float, pool: int,
                 stride: int) -> torch.Tensor:
    """Two-sided rectify + sum pool. x (N,H,W,K) f32 → (N,gy,gx,2K) f32.
    CUDA tensors run the kernel in ``csrc/rectify_pool.cu``; CPU tensors
    run `rectify_pool_reference`."""
    if x.device.type == "cpu":
        return rectify_pool_reference(x, alpha, max_val, pool, stride)
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
    rectify_pool.launches += 1
    return out


rectify_pool.launches = 0


def rectify_pool_vectorize(x, alpha: float, max_val: float, pool: int,
                           stride: int) -> torch.Tensor:
    """`rectify_pool` followed by a flatten to (N, gy·gx·2K): the same
    kernel, and a view of its output."""
    y = rectify_pool(x, alpha, max_val, pool, stride)
    return y.reshape(y.shape[0], -1)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    conv_rectify_pool.launches = 0
    rectify_pool.launches = 0
