"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU and skip without one; they import
no JAX, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from keystone_tpu_torch.ops import kernels

# geometries and ragged counts of tests/test_pallas_ops.py:117-160, plus
# the headline width at a ragged count
CONV_GEOMETRIES = [
    (5, 32, 32, 3, 6, 32, 14, 13, True),
    (3, 16, 16, 1, 5, 16, 6, 6, False),
    (2, 20, 14, 2, 3, 8, 5, 4, True),
    (3, 16, 16, 1, 2, 8, 5, 5, False),
    (5, 12, 12, 1, 3, 8, 10, 10, True),
    (3, 12, 10, 2, 3, 8, 8, 2, False),
    (37, 32, 32, 3, 6, 256, 14, 13, True),
]

# geometries of tests/test_pallas_ops.py:25-40, plus a ragged width
RECTIFY_GEOMETRIES = [
    (3, 27, 27, 16, 14, 13, 0.25, 0.0),
    (5, 12, 12, 8, 4, 4, 0.0, 0.0),
    (2, 10, 14, 4, 5, 3, 0.1, 0.05),
    (37, 27, 27, 100, 14, 13, 0.25, 0.0),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from keystone_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         CONV_GEOMETRIES)
def test_cuda_conv_rectify_pool_matches_plain(
        cuda_device, n, h, w, c, patch, k, pool, stride, normalize):
    """The CUDA kernel (bf16 operands, fp32 sums) against its fp32 plain
    version on the card: 5e-3 of the output's scale, the bf16 class."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random(size=(n, h, w, c)), dtype=torch.float32,
                     device=cuda_device)
    kern = torch.tensor(rng.normal(size=(patch, patch, c, k)),
                        dtype=torch.float32, device=cuda_device)
    colsum, bias = (torch.tensor(rng.normal(size=(k,)), dtype=torch.float32,
                                 device=cuda_device) for _ in range(2))
    g = kernels.hwio_to_cmajor(kern).contiguous()
    before = kernels.conv_rectify_pool.launches
    got = kernels.conv_rectify_pool(x, g, colsum, bias, 0.25, 0.0, pool,
                                    stride, normalize, patch)
    torch.cuda.synchronize()
    assert kernels.conv_rectify_pool.launches == before + 1
    want = kernels.conv_rectify_pool_reference(x, kern, colsum, bias, 0.25,
                                               0.0, pool, stride, normalize)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 5e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,k,pool,stride,alpha,max_val",
                         RECTIFY_GEOMETRIES)
def test_cuda_rectify_pool_matches_plain(cuda_device, n, h, w, k, pool,
                                         stride, alpha, max_val):
    """The CUDA kernel against its plain version: fp32 summation order,
    1e-5 of the output's scale."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(n, h, w, k)),
                     dtype=torch.float32, device=cuda_device)
    before = kernels.rectify_pool.launches
    got = kernels.rectify_pool(x, alpha, max_val, pool, stride)
    torch.cuda.synchronize()
    assert kernels.rectify_pool.launches == before + 1
    want = kernels.rectify_pool_reference(x, alpha, max_val, pool, stride)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """No silent copy or fallback: wrong dtype or layout raises."""
    x = torch.zeros((2, 27, 27, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.rectify_pool(x, 0.25, 0.0, 14, 13)
    x = torch.zeros((2, 8, 27, 27), device=cuda_device).permute(0, 2, 3, 1)
    with pytest.raises(ValueError):
        kernels.rectify_pool(x, 0.25, 0.0, 14, 13)
