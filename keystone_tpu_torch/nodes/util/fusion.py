"""Stage fusion + microbatching.

Counterpart of `keystone_tpu/nodes/util/fusion.py`: `FusedBatchTransformer`
(`:320-`) runs a chain of stages over microbatches of rows, so only one
microbatch's intermediates are alive at a time, and `_peephole`
(`:141-176`) merges Convolver >> SymmetricRectifier >> Pooler(sum) into
the fused conv+rectify+pool kernel and a bare SymmetricRectifier >>
Pooler(sum) into the rectify+pool kernel (`ops/kernels.py`). The JAX
package's program caching, planned precision, sharding tags and planned
chain kernels have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...ops.kernels import conv_rectify_pool, hwio_to_cmajor, rectify_pool
from ...workflow.pipeline import Transformer


class _RectifyPoolStage(Transformer):
    """SymmetricRectifier >> Pooler(sum) through the rectify+pool kernel."""

    def __init__(self, alpha: float, max_val: float, pool: int, stride: int):
        self.alpha = alpha
        self.max_val = max_val
        self.pool = pool
        self.stride = stride

    def batch_fn(self):
        return lambda x: rectify_pool(x, self.alpha, self.max_val, self.pool,
                                      self.stride)


class _ConvRectifyPoolStage(Transformer):
    """Convolver >> SymmetricRectifier >> Pooler(sum) through the fused
    conv+rectify+pool kernel: the conv output and the channel-doubled
    activations never reach device memory."""

    def __init__(self, conv, alpha: float, max_val: float, pool: int,
                 stride: int):
        self.alpha = alpha
        self.max_val = max_val
        self.pool = pool
        self.stride = stride
        self.patch = conv.patch
        self.normalize = conv.normalize_patches
        self.g_cmajor = hwio_to_cmajor(conv.kernel).contiguous()
        self.colsum = conv.colsum.contiguous()
        self.bias = conv.bias.contiguous()

    def batch_fn(self):
        return lambda x: conv_rectify_pool(
            x.contiguous(), self.g_cmajor, self.colsum, self.bias,
            self.alpha, self.max_val, self.pool, self.stride, self.normalize,
            self.patch)


def _is_sum_pooler(stage) -> bool:
    from ..images.core import Pooler

    return (isinstance(stage, Pooler) and stage.pool_fn == "sum"
            and stage.pixel_fn is None)


def _peephole(stages):
    """Merge adjacent (Convolver?, SymmetricRectifier, Pooler[sum])
    stages into one kernel stage."""
    from ..images.core import Convolver, SymmetricRectifier

    out, i = [], 0
    while i < len(stages):
        s = stages[i]
        if (isinstance(s, Convolver) and i + 2 < len(stages)
                and isinstance(stages[i + 1], SymmetricRectifier)
                and _is_sum_pooler(stages[i + 2])):
            r, p = stages[i + 1], stages[i + 2]
            out.append(_ConvRectifyPoolStage(s, r.alpha, r.max_val,
                                             p.pool_size, p.stride))
            i += 3
        elif (isinstance(s, SymmetricRectifier) and i + 1 < len(stages)
              and _is_sum_pooler(stages[i + 1])):
            p = stages[i + 1]
            out.append(_RectifyPoolStage(s.alpha, s.max_val, p.pool_size,
                                         p.stride))
            i += 2
        else:
            out.append(s)
            i += 1
    return out


class FusedBatchTransformer(Transformer):
    """Run ``stages`` (after the peephole) over consecutive microbatches
    of ``microbatch`` rows; the last microbatch is ragged."""

    def __init__(self, stages: Sequence[Transformer], microbatch: int = 2048):
        self.stages = list(stages)
        self.microbatch = microbatch

    def batch_fn(self):
        fns = [s.batch_fn() for s in _peephole(self.stages)]

        def run(xb):
            for fn in fns:
                xb = fn(xb)
            return xb

        def fn(x):
            out = None
            for start in range(0, x.shape[0], self.microbatch):
                y = run(x[start:start + self.microbatch])
                if out is None:
                    out = torch.empty((x.shape[0],) + tuple(y.shape[1:]),
                                      dtype=y.dtype, device=y.device)
                out[start:start + y.shape[0]] = y
            return out if out is not None else run(x)

        return fn
