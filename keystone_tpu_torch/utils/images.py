"""Image utilities (counterpart of `keystone_tpu/utils/images.py`:
`grayscale` `:48-53`, `crop` `:56`, `flip_horizontal` `:61`,
`extract_patches_device` `:119-135`).

`crop` and `flip_horizontal` take one (H, W, C) image or an (N, H, W, C)
batch: they index the last three axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
