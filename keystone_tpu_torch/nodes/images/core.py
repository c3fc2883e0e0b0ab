"""Core image featurization nodes.

Counterpart of `keystone_tpu/nodes/images/core.py` (`PixelScaler`,
`Convolver` `:44-125`, `SymmetricRectifier`, `Pooler`, `ImageVectorizer`,
`GrayScaler` `:268-306`). Images are NHWC. The stages an elementwise
chain kernel can absorb carry a `fuse` method that returns the JAX
package's static key and parameters (`core.py:228, 257, 279`), which the
fusion matcher reads (`nodes/util/fusion.py`). The Convolver folds the
ZCA whitener and the patch-mean normalization into the conv:

    out[p, k] = (patch_p − mean(patch_p)·1 − zca_mean) · (W_zca f_k)
              = conv(img, G)[p, k] − mean_p · colsum(G_k) − zca_mean·G_k

with G = W_zca @ F, computed in true float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.kernels import folded_conv_reference
from ...utils.images import grayscale
from ...workflow.pipeline import Transformer


class PixelScaler(Transformer):
    """x / 255 (PixelScaler.scala:9)."""

    def batch_fn(self):
        return lambda x: x.to(torch.float32) / 255.0

    def fuse(self):
        return ("PixelScaler",), ()


class GrayScaler(Transformer):
    """NTSC grayscale (GrayScaler.scala:9): (..., 3) → (..., 1), the
    identity on one channel."""

    def batch_fn(self):
        return grayscale

    def fuse(self):
        return ("GrayScaler",), ()


class Convolver(Transformer):
    """Valid-mode convolution of a filter bank over NHWC image batches
    (Convolver.scala:20-221), with folded patch-mean normalization and
    ZCA whitening.

    filters: (K, D) with D = patch·patch·C in (patch, patch, C) order, or
    (K, patch, patch, C); a tensor or an array. The folded bank lives on
    the filters' device (an array goes to ``device``)."""

    def __init__(self, filters, img_height: int, img_width: int,
                 img_channels: int, whitener=None,
                 normalize_patches: bool = True,
                 patch_size: Optional[int] = None, device="cuda"):
        if not isinstance(filters, torch.Tensor):
            filters = torch.as_tensor(np.asarray(filters), device=device)
        filters = filters.to(torch.float32)
        if filters.ndim == 2:
            if patch_size is None:
                patch_size = int(round((filters.shape[1] / img_channels) ** 0.5))
            filters = filters.reshape(-1, patch_size, patch_size, img_channels)
        self.patch = filters.shape[1]
        self.num_filters = filters.shape[0]
        self.img_shape = (img_height, img_width, img_channels)
        self.whitener = whitener
        self.normalize_patches = normalize_patches

        d = self.patch * self.patch * img_channels
        fmat = filters.reshape(self.num_filters, d).T  # (D, K)
        if whitener is not None:
            g = whitener.whitener.to(fmat) @ fmat       # (D, K)
            bias = -(whitener.means.to(fmat) @ g)
        else:
            g = fmat
            bias = torch.zeros(self.num_filters, dtype=torch.float32,
                               device=fmat.device)
        self.kernel = (g.T.reshape(self.num_filters, self.patch, self.patch,
                                   img_channels)
                       .permute(1, 2, 3, 0).contiguous())  # HWIO
        self.colsum = g.sum(dim=0)
        self.bias = bias

    def batch_fn(self):
        return lambda imgs: folded_conv_reference(
            imgs, self.kernel, self.colsum, self.bias, self.normalize_patches)


class SymmetricRectifier(Transformer):
    """Two-sided ReLU: channels double to [max(mv, x−α), max(mv, −x−α)]
    (SymmetricRectifier.scala:7-32)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def batch_fn(self):
        return lambda x: torch.cat(
            [torch.clamp(x - self.alpha, min=self.max_val),
             torch.clamp(-x - self.alpha, min=self.max_val)], dim=-1)


class Pooler(Transformer):
    """Strided sum or max pooling over (N, H, W, C) with an elementwise
    pre-map (Pooler.scala:21-69)."""

    def __init__(self, stride: int, pool_size: int, pixel_fn=None,
                 pool_fn: str = "sum"):
        if pool_fn not in ("sum", "max"):
            raise ValueError("pool_fn must be 'sum' or 'max'")
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_fn = pixel_fn
        self.pool_fn = pool_fn

    def batch_fn(self):
        def fn(x):
            y = x if self.pixel_fn is None else self.pixel_fn(x)
            y = y.permute(0, 3, 1, 2)
            if self.pool_fn == "sum":
                y = F.avg_pool2d(y, self.pool_size, self.stride,
                                 divisor_override=1)
            else:
                y = F.max_pool2d(y, self.pool_size, self.stride)
            return y.permute(0, 2, 3, 1).contiguous()

        return fn


class ImageVectorizer(Transformer):
    """(H, W, C) → flat vector (ImageVectorizer.scala:12)."""

    def batch_fn(self):
        return lambda x: x.reshape(x.shape[0], -1)

    def fuse(self):
        return ("ImageVectorizer",), ()
