"""The fused conv kernel's row plan against the JAX package's pool matrix.

The CUDA kernel (`keystone_tpu_torch/csrc/conv_rectify_pool.cu`) pools
through `conv_row_plan`: each conv position that some window covers is one
entry, grouped with entries of the same window ranges, and each group's
sums are added into every window of its class. These tests hold that plan, and
`pool_window_ranges` under it, against the 0/1 weights of the JAX
kernel's pool product (`keystone_tpu/ops/pallas_kernels.py::_pool_matrix`)
at every geometry the card tests run, and the split of a large filter
bank into launches.
"""

import numpy as np
import pytest

from keystone_tpu.ops.pallas_kernels import _pool_matrix
from keystone_tpu_torch.ops import kernels
from test_torch_cuda_kernels import CONV_GEOMETRIES


def _positions(h, w, patch, pool, stride):
    pos_h, pos_w = h - patch + 1, w - patch + 1
    gy, gx = kernels.pooled_grid(pos_h, pos_w, pool, stride)
    return pos_h, pos_w, gy, gx


def _jax_weights(pos_h, pos_w, pool, stride, cells):
    return _pool_matrix(pos_h, pos_w, pos_h * pos_w, pool, stride, 1)[:cells]


def _unpack(word):
    return (word & 127, (word >> 7) & 127, (word >> 14) & 127,
            (word >> 21) & 127, bool(word & kernels.CONV_PAD_FLAG))


@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         CONV_GEOMETRIES)
def test_pool_window_ranges_match_jax_pool_matrix(
        n, h, w, c, patch, k, pool, stride, normalize):
    """Position (y, x) lies in window (wy, wx) exactly when wy is in y's
    range and wx in x's, as the nonzeros of `_pool_matrix` (g=1) say."""
    pos_h, pos_w, gy, gx = _positions(h, w, patch, pool, stride)
    fy, ly = (t.numpy() for t in kernels.pool_window_ranges(pos_h, pool,
                                                            stride))
    fx, lx = (t.numpy() for t in kernels.pool_window_ranges(pos_w, pool,
                                                            stride))
    wy = np.arange(gy)[:, None, None, None]
    wx = np.arange(gx)[None, :, None, None]
    y = np.arange(pos_h)[None, None, :, None]
    x = np.arange(pos_w)[None, None, None, :]
    member = ((fy[y] <= wy) & (wy <= ly[y]) & (fx[x] <= wx) & (wx <= lx[x]))
    want = _jax_weights(pos_h, pos_w, pool, stride, gy * gx) != 0
    np.testing.assert_array_equal(
        member.reshape(gy * gx, pos_h * pos_w), want)


@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         CONV_GEOMETRIES)
def test_conv_row_plan_pools_like_jax_pool_matrix(
        n, h, w, c, patch, k, pool, stride, normalize):
    """Every covered position is one entry and no other is; each group of
    `CONV_GROUP_ROWS` entries shares one class, flagged where it holds
    padding; summing each group and adding it into every window of its
    class, as the kernel does, equals the JAX kernel's pool product on
    the same activations."""
    pos_h, pos_w, gy, gx = _positions(h, w, patch, pool, stride)
    row_pos, groups = (t.numpy() for t in kernels.conv_row_plan(
        pos_h, pos_w, pool, stride))
    weights = _jax_weights(pos_h, pos_w, pool, stride, gy * gx)
    assert groups.size * kernels.CONV_GROUP_ROWS == row_pos.size
    covered = np.flatnonzero(weights.any(axis=0))
    np.testing.assert_array_equal(np.sort(row_pos[row_pos >= 0]), covered)

    fy, ly = kernels.pool_window_ranges(pos_h, pool, stride)
    fx, lx = kernels.pool_window_ranges(pos_w, pool, stride)
    act = np.random.default_rng(4).random((pos_h * pos_w, 3))
    pooled = np.zeros((gy * gx, 3))
    for i, word in enumerate(groups):
        wy0, wy1, wx0, wx1, padded = _unpack(int(word))
        members = row_pos[i * kernels.CONV_GROUP_ROWS:
                          (i + 1) * kernels.CONV_GROUP_ROWS]
        assert padded == bool((members < 0).any())
        members = members[members >= 0]
        assert members.size > 0
        ys, xs = members // pos_w, members % pos_w
        assert {int(fy[v]) for v in ys} == {wy0}
        assert {int(ly[v]) for v in ys} == {wy1}
        assert {int(fx[v]) for v in xs} == {wx0}
        assert {int(lx[v]) for v in xs} == {wx1}
        for cy in range(wy0, wy1 + 1):
            for cx in range(wx0, wx1 + 1):
                pooled[cy * gx + cx] += act[members].sum(axis=0)
    np.testing.assert_allclose(pooled, weights.astype(np.float64) @ act,
                               rtol=1e-12)


def _headline_smem(filters):
    """Shared memory of one block at 32x32x3, P 6, pool 14 stride 13:
    102,672 bytes of image, patch and plan buffers, then per filter (in
    64-filter tiles) 224 bytes of bf16 bank, 8 of colsum and bias and 32
    of pool sums."""
    tiles = -(-filters // kernels.CONV_FILTER_TILE) * kernels.CONV_FILTER_TILE
    return 102_672 + 232 * tiles + 32 * filters


@pytest.mark.parametrize("k,chunk", [(8, 8), (100, 100), (256, 256),
                                     (448, 448), (449, 448), (512, 448),
                                     (520, 448), (2000, 448)])
def test_conv_filter_chunk_splits_what_does_not_fit(k, chunk):
    """The whole bank where it fits, else the largest fitting multiple of
    the filter tile; the limit is the kernel's own."""
    assert kernels.conv_filter_chunk(k, _headline_smem) == chunk
    assert _headline_smem(chunk) <= kernels.MAX_SMEM_BYTES


def test_conv_filter_chunk_is_zero_when_no_tile_fits():
    assert kernels.conv_filter_chunk(256, lambda f: 300_000) == 0
