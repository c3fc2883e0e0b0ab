"""Dense grid descriptors: LCS (local color statistics).

Counterpart of `keystone_tpu/nodes/images/descriptors.py`:
`_GridDescriptorExtractor` (`:23-62`) and `LCSExtractor` (`:65-99`;
reference LCSExtractor.scala:25-130). Per-pixel channel maps, a box
filter as two depthwise convolutions, and a strided gather at the grid's
sub-patches, batched over images of one shape. `HogExtractor` and
`DaisyExtractor` (`:102, :234`) are not ported yet (ROADMAP queue 1,
item 8).
"""

from __future__ import annotations

import torch

from ...utils.images import sep_conv_nchw
from ...workflow.pipeline import Transformer


class _GridDescriptorExtractor(Transformer):
    """A batched per-image function over (B, H, W, C) images: over a
    `HostDataset` one call a bucket chunk of equal-shape images, over a
    device `Dataset` one call."""

    def _batch(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def batch_fn(self):
        return lambda x: self._batch(x.to(torch.float32))


class LCSExtractor(_GridDescriptorExtractor):
    """Local color statistics: the mean and the standard deviation of
    each sub-patch of each channel around keypoints on a grid →
    (num_keypoints, 2·C·subpatches²), means first
    (LCSExtractor.scala:25-130).

    The box filter is ``subpatch_size`` wide with XLA's SAME zero
    padding (for 6: 2 before, 3 after). ``std = sqrt(max(E[x²] − E[x]²,
    0))`` cancels where a patch is flat, so it carries the float32
    rounding of E[x²] there."""

    def __init__(self, stride: int = 4, subpatch_size: int = 6,
                 subpatches: int = 4):
        self.stride = stride
        self.subpatch_size = subpatch_size
        self.subpatches = subpatches  # per axis
        self._box: dict = {}   # the box filter's taps, by device

    def _batch(self, images):
        sp, g, stride = self.subpatch_size, self.subpatches, self.stride
        b, h, w, c = images.shape
        dev = images.device
        if dev not in self._box:
            self._box[dev] = torch.full((sp,), 1.0 / sp, device=dev)
        box = self._box[dev]
        x = images.permute(0, 3, 1, 2)
        mean = sep_conv_nchw(x, box, box, "same")
        mean2 = sep_conv_nchw(x * x, box, box, "same")
        std = torch.sqrt(torch.clamp(mean2 - mean * mean, min=0.0))
        span = g * sp
        n_y = max((h - span) // stride + 1, 0)
        n_x = max((w - span) // stride + 1, 0)
        off = sp // 2
        sub = torch.arange(g, device=dev) * sp
        yy = (torch.arange(n_y, device=dev) * stride + off)[:, None] + sub
        xx = (torch.arange(n_x, device=dev) * stride + off)[:, None] + sub
        # (B, C, n_y, g, n_x, g) → keypoints row-outer: (B, n_y, n_x, g,
        # g, C)
        feats = [m[:, :, yy][..., xx].permute(0, 2, 4, 3, 5, 1)
                 .reshape(b, n_y * n_x, g * g * c) for m in (mean, std)]
        return torch.cat(feats, dim=2)
