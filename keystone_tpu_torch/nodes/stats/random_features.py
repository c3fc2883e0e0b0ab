"""Randomized featurization nodes.

Counterpart of `keystone_tpu/nodes/stats/random_features.py`:

- `CosineRandomFeatures` (`:24-85`): cos(x W + b), W drawn as
  gamma·N(0, 1) (or gamma·Cauchy) and b as U[0, 2π) from one numpy
  generator (reference nodes/stats/CosineRandomFeatures.scala:20-61);
- `RandomSignNode` (`:88-109`): x ∘ a fixed random ±1 vector
  (RandomSignNode.scala:11-24);
- `PaddedFFT` (`:112-143`): zero-pad to the next power of two, FFT, the
  real part of the first half of the bins (PaddedFFT.scala:13-21);
- `LinearRectifier` (`:146-168`): max(maxVal, x − α)
  (LinearRectifier.scala:12-17).

Every draw is a numpy draw from the node's seed, made exactly as the JAX
package makes it, so both packages hold the same weights. The ``fuse``
keys carry the JAX package's stage heads, so `ops.chain_kernels.
lowerability` gives its verdict on a chain of these nodes: `PaddedFFT` is
a named suppression, and the FFT stays on cuFFT through `torch.fft`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...workflow.pipeline import Transformer


class CosineRandomFeatures(Transformer):
    """cos(x W + b) with W (input_dim, num_features) ~ gamma·N(0, 1)
    (``"gaussian"``) or gamma·Cauchy (``"cauchy"``), b ~ U[0, 2π)."""

    precision_tolerance = "tolerant"

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, input_dim: int, num_features: int, gamma: float = 1.0,
                 distribution: str = "gaussian", seed: int = 0,
                 device: DeviceLike = "cuda"):
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        if distribution == "gaussian":
            W = rng.standard_normal((input_dim, num_features))
        elif distribution == "cauchy":
            W = rng.standard_cauchy((input_dim, num_features))
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        # float64 draws scaled, then rounded once to float32, as JAX does
        self.W = torch.as_tensor((gamma * W).astype(np.float32),
                                 device=device)
        self.b = torch.as_tensor(
            rng.uniform(0, 2 * np.pi, size=(num_features,)).astype(
                np.float32), device=device)

    def batch_fn(self):
        # one GEMM with the bias added in its epilogue, the cosine in place
        return lambda x: torch.addmm(self.b, x, self.W).cos_()

    def fuse(self):
        return ("CosineRandomFeatures",), (self.W, self.b)


class RandomSignNode(Transformer):
    """Elementwise product with a fixed random ±1 vector."""

    precision_tolerance = "tolerant"  # elementwise ±1 flip

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, dim: int, seed: int = 0, device: DeviceLike = "cuda"):
        rng = np.random.default_rng(seed)
        self.signs = torch.as_tensor(
            (rng.integers(0, 2, size=(dim,)) * 2 - 1).astype(np.float32),
            device=resolve_device(device))

    def batch_fn(self):
        return lambda x: x * self.signs

    def fuse(self):
        return ("RandomSignNode",), (self.signs,)


def padded_width(n: int) -> int:
    """The next power of two at or above ``n``."""
    return 1 << max(math.ceil(math.log2(n)), 0)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A floating input narrower than float32 widens to float32 (the FFT
    takes float32 or float64)."""
    if x.is_floating_point() and x.dtype != torch.float64:
        return x.to(torch.float32)
    return x


class PaddedFFT(Transformer):
    """Zero-pad the last axis to the next power of two and keep the real
    part of the first half of the real FFT's bins (the Nyquist bin is
    dropped, as in the JAX package)."""

    precision_tolerance = "tolerant"  # featurize transform

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def batch_fn(self):
        def fn(x):
            padded = padded_width(x.shape[-1])
            return torch.fft.rfft(_widen(x), n=padded).real[..., :padded // 2]

        return fn

    def fuse(self):
        return ("PaddedFFT",), ()


class LinearRectifier(Transformer):
    """max(max_val, x − alpha)."""

    precision_tolerance = "tolerant"  # elementwise max/sub

    chunkable = True  # per-item: distributes over chunks

    fusable = True

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = max_val
        self.alpha = alpha

    def batch_fn(self):
        return lambda x: torch.clamp_min(x - self.alpha, self.max_val)

    def fuse(self):
        return ("LinearRectifier",), (np.float64(self.max_val),
                                      np.float64(self.alpha))
