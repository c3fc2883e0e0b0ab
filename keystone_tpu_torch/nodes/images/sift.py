"""Dense multi-scale SIFT, vl_dsift fast-mode numerics, batched.

Counterpart of `keystone_tpu/nodes/images/sift.py` (`:63-223`;
reference nodes/images/external/SIFTExtractor.scala:16-40 → VLFeat.cxx:
40-210). Per scale s: bin size b = bin + 2s, step = step + s·scale_step,
frame offset off = max((1 + 2·num_scales) − 3s, 0) (clamped, as vl_dsift
clamps its bounds: from 5 scales on the raw offset goes negative), then
on a batch of grayscale images of one shape:

  1. Gaussian smoothing, σ = b/6, support ceil(4σ), edge replication
     (vl_imsmooth_f), as two depthwise `F.conv2d` calls;
  2. gradients, central inside and one-sided at the borders
     (`torch.gradient(..., edge_order=1)`, as `jnp.gradient`);
  3. the magnitude soft-assigned to 8 orientation channels by linear
     interpolation between adjacent bins (`torch.remainder` takes the
     divisor's sign, as `jnp.mod`);
  4. spatial binning: a triangular filter of half-width b per channel,
     edge replication (vl_imconvcoltri_f);
  5. a gather at the bin centres, frames column-outer and row-inner,
     each spatial bin weighted by the flat window's Gaussian mean;
     descriptor layout [row bin, column bin, orientation];
  6. L2 (+ε) → clamp 0.2 → L2 (+ε), zero where the first norm is below
     the contrast threshold, then min(floor(512·v), 255).

Every image of a batch gives the same number of descriptors, so a
bucket of equal-shape images is one chain of batched torch ops. The last
step amplifies rounding: where 512·v lies within an ulp of an integer, a
different summation order moves an entry by exactly 1
(`tests/test_torch_descriptors.py` states the share).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...utils.images import sep_conv_nchw
from ...workflow.pipeline import Transformer

NUM_ORIENTATIONS = 8
GRID = 4  # 4x4 spatial bins
VL_EPSILON_F = 1.19209290e-07
CONTRAST_THRESHOLD = 0.005  # VLFeat.cxx:63
WINDOW_SIZE = 1.5           # VLFeat.cxx:104
MAGNIF = 6.0                # VLFeat.cxx:45


def _gaussian_taps(sigma: float) -> np.ndarray:
    """vl_imsmooth_f kernel: support ceil(4σ), normalized."""
    radius = max(int(np.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _triangular_taps(bin_size: int) -> np.ndarray:
    """vl_imconvcoltri_f kernel: unit integral, taps (bs−|k|)/bs²."""
    bs = bin_size
    k = (bs - np.abs(np.arange(-(bs - 1), bs))).astype(np.float64)
    return (k / (bs * bs)).astype(np.float32)


def _bin_window_mean(bin_size: int, bin_index: int) -> float:
    """_vl_dsift_get_bin_window_mean × binSize: the Gaussian window's
    mean over the bin's triangular support."""
    delta = bin_size * (bin_index - (GRID - 1) / 2.0)
    sigma = bin_size * WINDOW_SIZE
    xs = np.arange(-bin_size + 1, bin_size, dtype=np.float64)
    return float(np.mean(np.exp(-0.5 * ((xs + delta) / sigma) ** 2))) \
        * bin_size


def scale_constants(bin_size: int, device) -> tuple:
    """(Gaussian taps, triangular taps, the bins' window means) of one
    scale, float32 tensors on ``device``."""
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in (
        _gaussian_taps(bin_size / MAGNIF), _triangular_taps(bin_size),
        [_bin_window_mean(bin_size, i) for i in range(GRID)]))


def _sift_one_scale(gray: torch.Tensor, bin_size: int, step: int, off: int,
                    constants: tuple) -> torch.Tensor:
    """(B, H, W) → (B, num_desc, 128) quantized floats of one scale;
    ``constants`` from `scale_constants`."""
    gauss, tri, wmean = constants
    sm = sep_conv_nchw(gray[:, None], gauss, gauss, "edge")[:, 0]
    b, h, w = sm.shape
    dy, dx = torch.gradient(sm, dim=(1, 2), edge_order=1)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)

    t = torch.remainder(ang / (2.0 * math.pi) * NUM_ORIENTATIONS,
                        NUM_ORIENTATIONS)
    lo = torch.floor(t)
    frac = t - lo
    lo = lo.to(torch.int64) % NUM_ORIENTATIONS
    hi = (lo + 1) % NUM_ORIENTATIONS
    o = torch.arange(NUM_ORIENTATIONS, device=gray.device)[None, :, None,
                                                           None]
    maps = ((lo[:, None] == o).to(torch.float32)
            * (mag * (1.0 - frac))[:, None]
            + (hi[:, None] == o).to(torch.float32)
            * (mag * frac)[:, None])  # (B, 8, H, W)
    agg = sep_conv_nchw(maps, tri, tri, "edge")

    span = bin_size * (GRID - 1) + 1
    n_r = max(((h - 1) - span + 1 - off) // step + 1, 0)
    n_c = max(((w - 1) - span + 1 - off) // step + 1, 0)
    dev = gray.device
    bin_off = torch.arange(GRID, device=dev) * bin_size
    rr = (off + torch.arange(n_r, device=dev) * step)[:, None] + bin_off
    cc = (off + torch.arange(n_c, device=dev) * step)[:, None] + bin_off
    # (B, 8, n_r, Gr, n_c, Gc) → frames column-outer, row-inner:
    # (B, n_c, n_r, Gr, Gc, 8)
    desc = agg[:, :, rr][..., cc].permute(0, 4, 2, 3, 5, 1)
    desc = desc * wmean[:, None, None] * wmean[:, None]
    desc = desc.reshape(b, n_c * n_r, GRID * GRID * NUM_ORIENTATIONS)

    norm = torch.linalg.vector_norm(desc, dim=2, keepdim=True) \
        + VL_EPSILON_F
    desc = torch.clamp(desc / norm, max=0.2)
    desc = desc / (torch.linalg.vector_norm(desc, dim=2, keepdim=True)
                   + VL_EPSILON_F)
    desc = torch.where(norm < CONTRAST_THRESHOLD, 0.0, desc)
    return torch.clamp(torch.floor(512.0 * desc), max=255.0)


def sift_batch(gray: torch.Tensor, step: int = 3, bin_size: int = 4,
               num_scales: int = 4, scale_step: int = 1,
               constants: Optional[dict] = None) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) images in [0, 1] → (B, num_desc, 128),
    the scales' descriptors concatenated. ``constants`` caches each
    scale's `scale_constants` by (bin size, device) across calls, so
    repeated calls copy no taps to the device."""
    if gray.ndim == 4:
        gray = gray[..., 0]
    gray = gray.to(torch.float32)
    constants = {} if constants is None else constants
    parts = []
    for s in range(num_scales):
        b = bin_size + 2 * s
        key = (b, gray.device)
        if key not in constants:
            constants[key] = scale_constants(b, gray.device)
        parts.append(_sift_one_scale(gray, b, step + s * scale_step,
                                     max((1 + 2 * num_scales) - 3 * s, 0),
                                     constants[key]))
    return torch.cat(parts, dim=1)


class SIFTExtractorInterface(Transformer):
    """(reference nodes/images/SIFTExtractor.scala:9)"""


class SIFTExtractor(SIFTExtractorInterface):
    """Dense multi-scale SIFT: a grayscale (H, W) or (H, W, 1) image in
    [0, 1] → (num_descriptors, 128) float matrix of quantized shorts in
    [0, 255] (external/SIFTExtractor.scala:16-40, scales concatenated).
    Defaults as SIFTExtractor.scala:17: step 3, bin 4, 4 scales, scale
    step 1. Over a `HostDataset` one batched call a bucket chunk; over a
    device `Dataset` of equal images one call."""

    chunkable = True  # per-item: distributes over chunks

    def __init__(self, step: int = 3, bin_size: int = 4, num_scales: int = 4,
                 scale_step: int = 1):
        self.step = step
        self.bin_size = bin_size
        self.num_scales = num_scales
        self.scale_step = scale_step
        self._constants: dict = {}

    def batch_fn(self):
        return lambda x: sift_batch(x, self.step, self.bin_size,
                                    self.num_scales, self.scale_step,
                                    self._constants)

    def apply_batch_stream(self, data):
        """The batched path's chunks over a `HostDataset`, each as it
        comes off the card (`keystone_tpu/nodes/images/sift.py:218-223`)."""
        return data.map_batches_stream(self.batch_fn())

