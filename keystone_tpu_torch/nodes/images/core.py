"""Core image featurization nodes.

Counterpart of `keystone_tpu/nodes/images/core.py` (`PixelScaler`,
`Convolver` `:44-125`, `SymmetricRectifier`, `Pooler`, `ImageVectorizer`,
`GrayScaler` `:268-306`, and the augmentation nodes `Cropper` `:308`,
`Windower` `:329`, `RandomPatcher` `:361-395`, `CenterCornerPatcher`
`:398-440`, `RandomImageTransformer` `:443-483`). Images are NHWC. The
augmentation nodes draw their offsets and flips from numpy's
``default_rng(seed)`` exactly as the JAX package does, so both packages
make the same crops; the crops themselves are device gathers. The
stages an elementwise chain kernel can absorb carry a `fuse` method that
returns the JAX package's static key and parameters (`core.py:228, 257,
279`), which the fusion matcher reads (`nodes/util/fusion.py`). The
Convolver folds the ZCA whitener and the patch-mean normalization into
the conv:

    out[p, k] = (patch_p − mean(patch_p)·1 − zca_mean) · (W_zca f_k)
              = conv(img, G)[p, k] − mean_p · colsum(G_k) − zca_mean·G_k

with G = W_zca @ F, computed in true float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import Dataset
from ...ops.kernels import folded_conv_reference
from ...telemetry.instrument import record_dispatch
from ...utils.images import (
    extract_patches_device,
    flip_horizontal,
    grayscale,
)
from ...workflow.pipeline import Transformer


class PixelScaler(Transformer):
    """x / 255 (PixelScaler.scala:9). Over a `HostDataset` (`core.py:
    232-262`) the images of one shape go through one batched call, on
    the device."""

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        return lambda x: x.to(torch.float32) / 255.0

    def fuse(self):
        return ("PixelScaler",), ()


class GrayScaler(Transformer):
    """NTSC grayscale (GrayScaler.scala:9): (..., 3) → (..., 1), the
    identity on one channel. Over a `HostDataset` (`core.py:268-305`)
    one batched call per image shape."""

    chunkable = True  # per-item: distributes over chunks

    fusable = True

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

    fusable = True

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

    fusable = True

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

    fusable = True

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

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        return lambda x: x.reshape(x.shape[0], -1)

    def fuse(self):
        return ("ImageVectorizer",), ()


class Cropper(Transformer):
    """The box rows y0..y1−1, columns x0..x1−1 of every image
    (Cropper.scala:19)."""

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, y0: int, x0: int, y1: int, x1: int):
        self.box = (y0, x0, y1, x1)

    def batch_fn(self):
        y0, x0, y1, x1 = self.box
        return lambda x: x[:, y0:y1, x0:x1, :]


class Windower(Transformer):
    """Every strided window of each image, flattened image-major: (N, H,
    W, C) → (N·gy·gx, w, w, C), so the count grows by gy·gx
    (Windower.scala:13-56)."""

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def batch_fn(self):
        return lambda x: extract_patches_device(x, self.window_size,
                                                self.stride)

    def apply(self, image):
        return self.batch_fn()(torch.as_tensor(image)[None])

    def apply_batch(self, data):
        record_dispatch()  # one batched call (JAX :345)
        h, w = data.array.shape[1:3]
        gy = (h - self.window_size) // self.stride + 1
        gx = (w - self.window_size) // self.stride + 1
        return Dataset(self.batch_fn()(data.array), count=data.count * gy * gx)


def gather_crops(images: torch.Tensor, img_idx: torch.Tensor,
                 ys: torch.Tensor, xs: torch.Tensor, patch_h: int,
                 patch_w: int) -> torch.Tensor:
    """Crop i is rows ys[i].., columns xs[i].. of image img_idx[i]: (M,)
    index tensors → (M, patch_h, patch_w, C), one device gather. The
    source is a strided view of every window (`Tensor.unfold`), so only
    the M offsets are materialized, never a per-pixel index."""
    windows = (images.unfold(1, patch_h, 1).unfold(2, patch_w, 1)
               .permute(0, 1, 2, 4, 5, 3))  # (N, H', W', ph, pw, C) view
    return windows[img_idx, ys, xs]


class RandomPatcher(Transformer):
    """``patches_per_image`` random crops of each image, image-major, so
    the count grows by that factor (RandomPatcher.scala:16-47). The batch
    path draws the offsets from ``default_rng(seed)`` on every call, the
    rows (ys) then the columns (xs), each (n, patches_per_image), as the
    JAX package does; one datum draws from a generator kept across
    calls."""

    def __init__(self, patches_per_image: int, patch_h: int, patch_w: int,
                 seed: int = 0):
        self.patches_per_image = patches_per_image
        self.patch_h = patch_h
        self.patch_w = patch_w
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def apply_batch(self, data):
        record_dispatch()  # one batched call (JAX :386)
        n = data.count
        images = data.array[:n]
        rng = np.random.default_rng(self.seed)
        size = (n, self.patches_per_image)
        ys = rng.integers(0, images.shape[1] - self.patch_h + 1, size=size)
        xs = rng.integers(0, images.shape[2] - self.patch_w + 1, size=size)
        dev = images.device
        img_idx = torch.arange(n, device=dev).repeat_interleave(
            self.patches_per_image)
        out = gather_crops(images, img_idx,
                           torch.as_tensor(ys.reshape(-1), device=dev),
                           torch.as_tensor(xs.reshape(-1), device=dev),
                           self.patch_h, self.patch_w)
        return Dataset(out, count=n * self.patches_per_image)

    def apply(self, image):
        y = self._rng.integers(0, image.shape[0] - self.patch_h + 1)
        x = self._rng.integers(0, image.shape[1] - self.patch_w + 1)
        return image[y:y + self.patch_h, x:x + self.patch_w]


class CenterCornerPatcher(Transformer):
    """The four corner crops and the centre crop of each image, then
    their horizontal flips where ``with_flips``; image-major, so the
    count grows by 5 or 10 (CenterCornerPatcher.scala:19-48)."""

    def __init__(self, patch_h: int, patch_w: int, with_flips: bool = False):
        self.patch_h = patch_h
        self.patch_w = patch_w
        self.with_flips = with_flips

    @property
    def views(self) -> int:
        return 10 if self.with_flips else 5

    def _starts(self, h: int, w: int):
        """The crops' top-left corners, in the JAX package's order."""
        ph, pw = self.patch_h, self.patch_w
        return [(0, 0), (0, w - pw), (h - ph, 0), (h - ph, w - pw),
                ((h - ph) // 2, (w - pw) // 2)]

    def _crops(self, images):
        """(N, views, ph, pw, C) from (N, H, W, C)."""
        ph, pw = self.patch_h, self.patch_w
        crops = [images[:, y:y + ph, x:x + pw]
                 for y, x in self._starts(images.shape[1], images.shape[2])]
        if self.with_flips:
            crops += [flip_horizontal(c) for c in crops]
        return torch.stack(crops, dim=1)

    def apply(self, image):
        return self._crops(torch.as_tensor(image)[None])[0]

    def apply_batch(self, data):
        record_dispatch()  # one batched call (JAX :429)
        crops = self._crops(data.array[:data.count])
        return Dataset(crops.reshape((-1,) + tuple(crops.shape[2:])),
                       count=data.count * self.views)


class RandomImageTransformer(Transformer):
    """``transform`` applied to each image with probability ``prob``
    (RandomImageTransformer.scala:15-31). The batch path draws the mask
    ``default_rng(seed).random(count) < prob`` on every call, as the JAX
    package does. A transform marked ``batchable`` (`flip_horizontal`:
    shape- and dtype-preserving) runs once on the whole batch and a
    device `torch.where` keeps the drawn rows; any other transform runs
    image by image on the host, as the JAX package runs a transform not
    marked traceable."""

    def __init__(self, prob: float, transform, seed: int = 0):
        self.prob = prob
        self.transform = transform
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def apply_batch(self, data):
        rng = np.random.default_rng(self.seed)
        flips = rng.random(data.count) < self.prob
        images = data.array[:data.count]
        if getattr(self.transform, "batchable", False):
            mask = torch.as_tensor(flips, device=images.device)
            mask = mask.reshape((-1,) + (1,) * (images.ndim - 1))
            return data.with_data(
                torch.where(mask, self.transform(images), images))
        host = images.cpu().clone()
        for i in np.nonzero(flips)[0]:
            host[i] = torch.as_tensor(self.transform(host[i]))
        return Dataset(host, device=images.device)

    def apply(self, image):
        if self._rng.random() < self.prob:
            return self.transform(image)
        return image
