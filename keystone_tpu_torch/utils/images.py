"""Image utilities (counterpart of `keystone_tpu/utils/images.py`)."""

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
