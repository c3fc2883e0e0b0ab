"""Image containers and utilities (counterpart of
`keystone_tpu/utils/images.py`: `ImageMetadata`, `LabeledImage`,
`MultiLabeledImage` `:23-46`, `grayscale` `:48-53`, `crop` `:56`,
`flip_horizontal` `:61`, `depthwise_conv2d` `:70-102`,
`extract_patches_device` `:119-135`).

`crop`, `flip_horizontal` and `depthwise_conv2d` take one (H, W, C)
image or an (N, H, W, C) batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ImageMetadata:
    """(reference utils/images/Image.scala:143)"""

    x_dim: int
    y_dim: int
    num_channels: int


@dataclass
class LabeledImage:
    """(reference utils/images/Image.scala:374-380)"""

    image: np.ndarray  # (H, W, C)
    label: int


@dataclass
class MultiLabeledImage:
    """(reference utils/images/Image.scala:385-394)"""

    image: np.ndarray
    labels: Sequence[int]
    filename: Optional[str] = None


def sep_conv_nchw(x: torch.Tensor, taps_y, taps_x,
                  padding: str = "same") -> torch.Tensor:
    """Separable depthwise convolution of (N, C, H, W) maps: one
    `F.conv2d(..., groups=C)` per axis, a cross-correlation as XLA's.
    The taps are sequences, arrays or tensors (on ``x``'s device, no
    copy).

    ``padding``: ``"same"`` pads with zeros as XLA's SAME does, k − 1 in
    all, (k − 1)//2 before and the rest after (so an even kernel puts its
    extra zero at the end); ``"edge"`` replicates the border by
    (k − 1)//2 on both sides and convolves valid (vlfeat's
    VL_PAD_BY_CONTINUITY), so an even kernel shortens the axis by one."""
    c = x.shape[1]
    ky = torch.as_tensor(taps_y, dtype=torch.float32, device=x.device)
    kx = torch.as_tensor(taps_x, dtype=torch.float32, device=x.device)
    ly, lx = ky.numel(), kx.numel()
    if padding == "edge":
        ry, rx = (ly - 1) // 2, (lx - 1) // 2
        x = F.pad(x, (rx, rx, ry, ry), mode="replicate")
    elif padding == "same":
        x = F.pad(x, ((lx - 1) // 2, lx - 1 - (lx - 1) // 2,
                      (ly - 1) // 2, ly - 1 - (ly - 1) // 2))
    else:
        raise ValueError(f"padding must be 'same' or 'edge', not {padding!r}")
    x = F.conv2d(x, ky.reshape(1, 1, ly, 1).expand(c, 1, ly, 1), groups=c)
    return F.conv2d(x, kx.reshape(1, 1, 1, lx).expand(c, 1, 1, lx), groups=c)


def depthwise_conv2d(image: torch.Tensor, kernel_y, kernel_x,
                     padding: str = "same") -> torch.Tensor:
    """Separable depthwise 2-D convolution of an (H, W, C) image or an
    (N, H, W, C) batch in float32, the rows first (ImageUtils.conv2D's
    separable path; `keystone_tpu/utils/images.py:70-102`). ``padding``
    as in `sep_conv_nchw`."""
    x = torch.as_tensor(image).to(torch.float32)
    single = x.ndim == 3
    if single:
        x = x[None]
    out = sep_conv_nchw(x.permute(0, 3, 1, 2), kernel_y, kernel_x, padding)
    out = out.permute(0, 2, 3, 1)
    return out[0] if single else out


def extract_patches_device(images: torch.Tensor, patch: int,
                           stride: int = 1) -> torch.Tensor:
    """(N, H, W, C) → (N·gy·gx, patch, patch, C): every strided window,
    rows in (image, y, x) order (`keystone_tpu/utils/images.py:119-135`).
    `F.unfold` yields channel-major (C, P, P) features; they are
    reordered to (P, P, C). A gather, so values are exact."""
    c = images.shape[-1]
    cols = F.unfold(images.permute(0, 3, 1, 2), patch, stride=stride)
    cols = cols.transpose(1, 2).reshape(-1, c, patch, patch)
    return cols.permute(0, 2, 3, 1)


#: NTSC luminance weights (ImageUtils.toGrayScale)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """NTSC luminance over the last axis, kept as an axis of 1; the
    identity when that axis is already 1
    (`keystone_tpu/utils/images.py:48-53`)."""
    if images.shape[-1] == 1:
        return images
    w = torch.tensor(GRAY_WEIGHTS, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) * w).sum(dim=-1, keepdim=True)


def crop(images: torch.Tensor, y0: int, x0: int, y1: int,
         x1: int) -> torch.Tensor:
    """Rows y0..y1−1 and columns x0..x1−1 (ImageUtils.crop): a view."""
    return images[..., y0:y1, x0:x1, :]


def flip_horizontal(images: torch.Tensor) -> torch.Tensor:
    """The columns in reverse order. `torch.flip` copies, as a tensor
    has no negative strides."""
    return torch.flip(images, dims=(-2,))


#: pure, shape- and dtype-preserving, no host state: a batch may be
#: flipped in one device call (`RandomImageTransformer` keys on this, as
#: the JAX package's device path keys on ``jax_traceable``)
flip_horizontal.batchable = True
