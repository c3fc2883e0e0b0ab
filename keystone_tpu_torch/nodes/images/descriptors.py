"""Dense grid descriptors: LCS, HOG and DAISY.

Counterpart of `keystone_tpu/nodes/images/descriptors.py`:
`_GridDescriptorExtractor` (`:23-62`), `LCSExtractor` (`:65-99`;
reference LCSExtractor.scala:25-130), `HogExtractor` (`:102-205`;
HogExtractor.scala:33-296), `daisy_blur_kernels`, `_round_half_up` and
`DaisyExtractor` (`:208-317`; DaisyExtractor.scala:28-201). Each is
per-pixel channel maps, separable aggregation and a strided gather on
the grid, as batched tensor code over images of one shape (B, H, W, C):
one call a bucket chunk of a `HostDataset`, one call a device
`Dataset`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.images import sep_conv_nchw
from ...workflow.pipeline import Transformer


class _GridDescriptorExtractor(Transformer):
    """A batched per-image function over (B, H, W, C) images: over a
    `HostDataset` one call a bucket chunk of equal-shape images, over a
    device `Dataset` one call."""

    chunkable = True  # per-item: distributes over chunks

    def _batch(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def batch_fn(self):
        return lambda x: self._batch(x.to(torch.float32))

    def apply_batch_stream(self, data):
        """The batched path's chunks over a `HostDataset`, each as it
        comes off the card (`keystone_tpu/nodes/images/descriptors.py:
        58-62`)."""
        return data.map_batches_stream(self.batch_fn())


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


class HogExtractor(_GridDescriptorExtractor):
    """Felzenszwalb–Girshick 32-dimensional HOG of each interior cell
    (HogExtractor.scala:33-296, a translation of voc-dpm's features.cc):
    ((cells_y − 2)·(cells_x − 2), 32), 18 contrast-sensitive, 9
    contrast-insensitive, 4 texture features and a zero. As JAX's
    (`:102-205`): orientations snapped to the best of 18 bins by the
    largest dot product with 9 unit vectors, zero gradients in bin 0;
    each pixel's magnitude spread over the 4 nearest cells by tent
    weights, as two tent-weight products; the four 2×2 cell-energy
    blocks around a cell normalize it; the reference's x is the row
    axis, and a tie between channels picks the highest channel."""

    def __init__(self, cell_size: int = 8):
        self.cell_size = cell_size

    def _batch(self, images):
        cs, eps = self.cell_size, 1e-4
        b, h, w, c = images.shape
        dev = images.device
        theta = np.arange(9) * np.pi / 9
        uu = torch.tensor(np.cos(theta), dtype=torch.float32, device=dev)
        vv = torch.tensor(np.sin(theta), dtype=torch.float32, device=dev)
        cells_r = int(np.floor(h / cs + 0.5))  # round half up
        cells_c = int(np.floor(w / cs + 0.5))
        vis_r, vis_c = min(cells_r * cs, h), min(cells_c * cs, w)
        gv = torch.zeros_like(images)
        gv[:, 1:-1] = images[:, 2:] - images[:, :-2]
        gh = torch.zeros_like(images)
        gh[:, :, 1:-1] = images[:, :, 2:] - images[:, :, :-2]
        mag2 = gv * gv + gh * gh
        # the channel of the largest gradient, ties to the highest index
        cidx = (c - 1) - torch.argmax(mag2.flip(-1), dim=-1, keepdim=True)
        gvb = torch.gather(gv, -1, cidx)[..., 0]
        ghb = torch.gather(gh, -1, cidx)[..., 0]
        mag = torch.sqrt(torch.gather(mag2, -1, cidx)[..., 0])
        r = torch.arange(h, device=dev)
        cc = torch.arange(w, device=dev)
        inside = (((r >= 1) & (r <= vis_r - 2))[:, None]
                  & ((cc >= 1) & (cc <= vis_c - 2))[None, :])
        mag = mag * inside
        # the interleaved (+o, −o) order keeps the reference's strict >
        # scan under argmax's first maximum
        dots = ghb[..., None] * uu + gvb[..., None] * vv
        j = torch.argmax(torch.stack([dots, -dots], dim=-1)
                         .reshape(b, h, w, 18), dim=-1)
        omaps = F.one_hot(j // 2 + 9 * (j % 2), 18).to(torch.float32) \
            * mag[..., None]
        rp = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / cs - 0.5
        cp = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / cs - 0.5
        wr = torch.clamp(1.0 - torch.abs(
            rp[None, :] - torch.arange(cells_r, device=dev)[:, None]), min=0.0)
        wc = torch.clamp(1.0 - torch.abs(
            cp[None, :] - torch.arange(cells_c, device=dev)[:, None]), min=0.0)
        hist = torch.einsum("yr,brco,xc->byxo", wr, omaps, wc)
        energy = torch.sum((hist[..., :9] + hist[..., 9:]) ** 2, dim=-1)
        fr, fc = cells_r - 2, cells_c - 2
        if fr <= 0 or fc <= 0:
            return images.new_zeros((b, 0, 32))
        # 2×2 block energies; feature cell (r, c) is hist cell (r+1, c+1)
        e2 = (energy[:, :-1, :-1] + energy[:, 1:, :-1]
              + energy[:, :-1, 1:] + energy[:, 1:, 1:])

        def inv(a):
            return 1.0 / torch.sqrt(a + eps)

        ns = [inv(e2[:, 1:1 + fr, 1:1 + fc]), inv(e2[:, 0:fr, 1:1 + fc]),
              inv(e2[:, 1:1 + fr, 0:fc]), inv(e2[:, 0:fr, 0:fc])]
        hc = hist[:, 1:1 + fr, 1:1 + fc, :]
        clipped = [torch.clamp(hc * n[..., None], max=0.2) for n in ns]
        f_sens = 0.5 * sum(clipped)
        hsum = hc[..., :9] + hc[..., 9:]
        f_insens = 0.5 * sum(torch.clamp(hsum * n[..., None], max=0.2)
                             for n in ns)
        f_tex = 0.2357 * torch.stack([cl.sum(dim=-1) for cl in clipped],
                                     dim=-1)
        out = torch.cat([f_sens, f_insens, f_tex,
                         hc.new_zeros((b, fr, fc, 1))], dim=-1)
        return out.reshape(b, fr * fc, 32)


def daisy_blur_kernels(radius: int, rings: int):
    """The reference's incremental DAISY blur taps
    (DaisyExtractor.scala:48-63): variance increments
    t_q = σ²(q+1) − σ²(q) with σ(n) = R·n/(2Q), the support from the
    conv-threshold formula, and the discrete Gaussian
    exp(−n²/2t)/√(2πt) left unnormalized (its sum is only about 1, and
    the MATLAB golden sums need it so)."""
    R, Q = radius, rings
    sigma_sq = [(R * n / (2.0 * Q)) ** 2 for n in range(Q + 1)]
    kernels = []
    for q in range(Q):
        t = sigma_sq[q + 1] - sigma_sq[q]
        support = int(np.ceil(np.sqrt(
            -2.0 * t * np.log(1e-6) - t * np.log(2.0 * np.pi * t))))
        n = np.arange(-support, support + 1, dtype=np.float64)
        kernels.append(np.exp(-(n ** 2) / (2.0 * t))
                       / np.sqrt(2.0 * np.pi * t))
    return kernels


def _round_half_up(v: float) -> int:
    """Scala's math.round, floor(v + 0.5), not numpy's half-to-even."""
    return int(math.floor(v + 0.5))


class DaisyExtractor(_GridDescriptorExtractor):
    """Dense DAISY (DaisyExtractor.scala:28-201): H half-rectified
    orientation maps of the [1,0,−1]⊗[1,2,1] gradients, blurred by
    Gaussians level on level (Q levels), sampled at each keypoint (level
    0) and at T points on each ring at angle 2π(t−1)/T, each H-histogram
    L2-normalized → (keypoints, H·(T·Q + 1)), keypoints row-major as
    JAX's (the reference returns the transpose). Images are gray
    (B, H, W) or the first channel of (B, H, W, C)."""

    def __init__(self, stride: int = 4, radius: int = 7, rings: int = 3,
                 ring_points: int = 8, num_orientations: int = 8,
                 pixel_border: int = 16):
        if pixel_border < radius:
            # the outermost ring lies radius away: a smaller border would
            # sample outside the image
            raise ValueError(f"pixel_border ({pixel_border}) must be >= "
                             f"radius ({radius})")
        self.stride = stride
        self.radius = radius
        self.rings = rings
        self.ring_points = ring_points
        self.num_orientations = num_orientations
        self.pixel_border = pixel_border

    def _offsets(self):
        """(level, row offset, column offset) of each ring point, t-major
        with the reference's (t − 1) phase (DaisyExtractor.scala:83)."""
        R, Q, T = self.radius, self.rings, self.ring_points
        out = []
        for t in range(T):
            theta = 2.0 * np.pi * (t - 1) / T
            for q in range(Q):
                r = R * (1.0 + q) / Q
                out.append((q, _round_half_up(r * np.sin(theta)),
                            _round_half_up(r * np.cos(theta))))
        return out

    def _batch(self, images):
        stride, border = self.stride, self.pixel_border
        T, Q, H = self.ring_points, self.rings, self.num_orientations
        gray = images[..., 0] if images.ndim == 4 else images
        b, h, w = gray.shape
        g = gray[:, None]
        # a true convolution with [1,0,-1] and [1,2,1] (conv2D reverses
        # its taps, ImageUtils.scala:267-268): correlate the reversed
        d, s = (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)
        ix = sep_conv_nchw(g, d, s)[:, 0]  # along the rows
        iy = sep_conv_nchw(g, s, d)[:, 0]  # along the columns
        angles = np.arange(H) * (2.0 * np.pi / H)
        acc = torch.stack([torch.clamp(np.cos(a) * ix + np.sin(a) * iy,
                                       min=0.0) for a in angles], dim=1)
        levels = []
        for taps in daisy_blur_kernels(self.radius, Q):
            acc = sep_conv_nchw(acc, taps, taps)
            levels.append(acc)
        n_x = max((h - 2 * border - 1) // stride + 1, 0)  # x: rows
        n_y = max((w - 2 * border - 1) // stride + 1, 0)
        cx = torch.arange(n_x, device=images.device) * stride + border
        cy = torch.arange(n_y, device=images.device) * stride + border

        def at(level, ox, oy):
            return level[:, :, cx + ox][:, :, :, cy + oy].permute(0, 2, 3, 1)

        hist = torch.stack([at(levels[0], 0, 0)] + [
            at(levels[q], ox, oy) for q, ox, oy in self._offsets()], dim=3)
        norm = torch.linalg.norm(hist, dim=-1, keepdim=True)
        hist = torch.where(norm > 1e-8, hist / torch.where(
            norm == 0.0, 1.0, norm), 0.0)
        return hist.reshape(b, n_x * n_y, (1 + T * Q) * H)
