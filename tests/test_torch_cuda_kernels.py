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

# geometries and ragged counts of tests/test_pallas_ops.py:117-160, the
# headline width at a ragged count, and the kernel's tile edges: a ragged
# 256-filter tile, two filter tiles, more images than one walk of the
# persistent blocks, the headline without the mean correction, banks
# too large for one block's shared memory (two launches, the second
# ragged at 520), and the augmented pipelines' 24x24 crops, pool 12
# stride 11 (one window an axis, which 217 of the 361 conv positions
# miss) at a microbatch and at a ragged count
CONV_GEOMETRIES = [
    (5, 32, 32, 3, 6, 32, 14, 13, True),
    (3, 16, 16, 1, 5, 16, 6, 6, False),
    (2, 20, 14, 2, 3, 8, 5, 4, True),
    (3, 16, 16, 1, 2, 8, 5, 5, False),
    (5, 12, 12, 1, 3, 8, 10, 10, True),
    (3, 12, 10, 2, 3, 8, 8, 2, False),
    (37, 32, 32, 3, 6, 256, 14, 13, True),
    (7, 32, 32, 3, 6, 100, 14, 13, True),
    (5, 32, 32, 3, 6, 384, 14, 13, True),
    (2049, 32, 32, 3, 6, 256, 14, 13, True),
    (64, 32, 32, 3, 6, 256, 14, 13, False),
    (3, 32, 32, 3, 6, 512, 14, 13, True),
    (4, 32, 32, 3, 6, 520, 14, 13, False),
    (2048, 24, 24, 3, 6, 256, 12, 11, True),
    (37, 24, 24, 3, 6, 256, 12, 11, True),
]

# at 32x32x3, P 6, pool 14 stride 13, one block holds at most this many
# filters of the bank; the wrapper launches once per such chunk
HEADLINE_FILTER_CHUNK = 448

# geometries of tests/test_pallas_ops.py:25-40, plus a ragged width
RECTIFY_GEOMETRIES = [
    (3, 27, 27, 16, 14, 13, 0.25, 0.0),
    (5, 12, 12, 8, 4, 4, 0.0, 0.0),
    (2, 10, 14, 4, 5, 3, 0.1, 0.05),
    (37, 27, 27, 100, 14, 13, 0.25, 0.0),
]


def _metric(name: str) -> float:
    """A process-wide counter of the port's metrics registry."""
    from keystone_tpu_torch.telemetry import counter

    return counter(name).value


def _peak_pinned():
    """The pinned ring's peak gauge, cleared: its ``max`` is what the
    streams after this call held at most."""
    from keystone_tpu_torch.telemetry import gauge

    g = gauge("overlap.peak_pinned_bytes")
    g.reset()
    return g


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
    chunk = HEADLINE_FILTER_CHUNK if (h, w, c, patch) == (32, 32, 3, 6) else k
    assert kernels.conv_rectify_pool.launches == before + -(-k // chunk)
    want = kernels.conv_rectify_pool_reference(x, kern, colsum, bias, 0.25,
                                               0.0, pool, stride, normalize)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 5e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,patch,k,pool,stride,normalize",
                         [CONV_GEOMETRIES[0], CONV_GEOMETRIES[3],
                          CONV_GEOMETRIES[9], CONV_GEOMETRIES[12]])
def test_cuda_conv_rectify_pool_takes_bf16_images(
        cuda_device, n, h, w, c, patch, k, pool, stride, normalize):
    """K1 on bf16 images (a planned bf16 storage trail): the same result,
    bit for bit, as on those values in float32, since the kernel rounds
    its operands to bf16 either way; and the plain version's on the same
    values within 5e-3 of the output's scale."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.random(size=(n, h, w, c)), dtype=torch.float32,
                     device=cuda_device).to(torch.bfloat16)
    kern = torch.tensor(rng.normal(size=(patch, patch, c, k)),
                        dtype=torch.float32, device=cuda_device)
    colsum, bias = (torch.tensor(rng.normal(size=(k,)), dtype=torch.float32,
                                 device=cuda_device) for _ in range(2))
    g = kernels.hwio_to_cmajor(kern).contiguous()
    args = (g, colsum, bias, 0.25, 0.0, pool, stride, normalize, patch)
    got = kernels.conv_rectify_pool(x, *args)
    as_f32 = kernels.conv_rectify_pool(x.float(), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, as_f32)
    want = kernels.conv_rectify_pool_reference(x.float(), kern, colsum, bias,
                                               0.25, 0.0, pool, stride,
                                               normalize)
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


# (statics, params as numpy, item shape, pixel scale) of the chains the
# CPU tests hold against JAX (tests/test_torch_chain_kernels.py)
def _chain(name, rng):
    if name == "linear_pixels":
        return ((("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",)),
                [(), (), ()], (32, 32, 3), 255.0)
    if name == "every_other_head":
        return ((("LinearRectifier",), ("RandomSignNode",),
                 ("SignedHellingerMapper",), ("NormalizeRows",),
                 (("StandardScaler", "scale"), "masked"),
                 ("StandardScaler", "center")),
                [(-0.3, 0.1),
                 (rng.choice([-1.0, 1.0], size=1024).astype(np.float32),),
                 (), (1e-3,),
                 (rng.normal(size=1024).astype(np.float32),
                  rng.uniform(0.5, 2.0, size=1024).astype(np.float32)),
                 (rng.normal(size=1024).astype(np.float32),)],
                (1024,), 1.0)
    return ((("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",),
             (("StandardScaler",), "masked")),
            [(), (), (), (rng.normal(size=36).astype(np.float32),
                          rng.uniform(0.5, 2.0, size=36).astype(np.float32))],
            (6, 6, 1), 255.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linear_pixels", "every_other_head",
                                  "one_channel"])
@pytest.mark.parametrize("n,masked_rows", [(37, 0), (37, 5), (300, 0)])
def test_cuda_elementwise_chain_matches_plain(cuda_device, name, n,
                                              masked_rows):
    """The chain kernel against its plain version on the card: max error
    over max |plain| within 1e-6 (only the reductions' order differs)."""
    from keystone_tpu_torch.ops import chain_kernels

    rng = np.random.default_rng(2)
    statics, params, item, scale = _chain(name, rng)
    x = rng.normal(size=(n,) + item) * scale
    x = torch.tensor(np.abs(x) if scale > 1.0 else x, dtype=torch.float32,
                     device=cuda_device)
    mask = None
    if masked_rows:
        mask = torch.arange(n, device=cuda_device) < n - masked_rows
    before = chain_kernels.elementwise_chain.launches
    got = chain_kernels.elementwise_chain(statics, params, x, mask)
    torch.cuda.synchronize()
    assert chain_kernels.elementwise_chain.launches == before + 1
    want = chain_kernels.elementwise_chain_reference(statics, params, x, mask)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,ranks", [(4096, 2), (4001, 2), (4001, 4)])
def test_cuda_rbf_block_on_a_rank_s_rows_is_the_whole_s(cuda_device, m,
                                                        ranks):
    """The data axis runs K5 on each rank's contiguous share of X (a KRR
    fit block's width and depth, counts 2 and 4 ranks pad): each share's
    block equals the whole matrix's block restricted to those rows, to
    5e-5 (a row's entries do not depend on the rows beside it; the plain
    version's bound)."""
    X, Yb, _ = _rbf_fit_block(cuda_device, m=m)
    whole = kernels.rbf_block(X, Yb, 2e-3)
    per = -(-m // ranks)
    for r in range(ranks):
        rows = X[r * per:(r + 1) * per].contiguous()
        got = kernels.rbf_block(rows, Yb, 2e-3)
        torch.cuda.synchronize()
        assert got.shape == (rows.shape[0], Yb.shape[0])
        assert float((got - whole[r * per:(r + 1) * per]).abs().max()) \
            <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,gamma", [
    (70, 33, 50, 0.07),      # ragged on every axis of a 128x128x32 tile
    (300, 257, 440, 0.01),   # bench.py's KRR width, ragged
    (1000, 2048, 2048, 2e-3),  # a fit block's width and depth
    # the 3xTF32 kernel's tile edges: m and n just under and over a
    # 128-row tile, depths that are not a multiple of the 32-float slab,
    # of 4 floats (rows of 37 floats: the prepass writes hi at stride
    # 40), or that are one whole slab
    (127, 129, 100, 0.02),
    (129, 127, 37, 0.05),
    (128, 128, 32, 0.1),
    (255, 257, 2052, 2e-3),
    # the augmented kernel pipeline's width (512 features, gamma 2e-4)
    # at a ragged m
    (3001, 2048, 512, 2e-4),
])
def test_cuda_rbf_block_matches_plain(cuda_device, m, n, d, gamma):
    """The RBF kernel against its plain version (fp32 matmul, TF32 off)
    on standardized rows and on a block against itself: 5e-5 absolute on
    outputs in (0, 1], where x2 + y2 - 2xy cancels on the diagonal."""
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                     device=cuda_device)
    Y = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                     device=cuda_device)
    for Yb in (Y, X[:min(m, n)].contiguous()):
        before = kernels.rbf_block.launches
        got = kernels.rbf_block(X, Yb, gamma)
        torch.cuda.synchronize()
        assert kernels.rbf_block.launches == before + 1
        want = kernels.rbf_block_reference(X, Yb, gamma)
        assert got.shape == want.shape == (m, Yb.shape[0])
        assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_cuda_rbf_block_counts_products_and_prepasses_apart(cuda_device):
    """One `rbf_block` call launches the prepass twice (X, then Yb) and
    the product once: ``rbf_split.launches`` grows by 2 and
    ``rbf_block.launches`` by 1, for raw and written hi parts alike."""
    rng = np.random.default_rng(12)
    for d in (512, 37):
        X = torch.tensor(rng.normal(size=(300, d)), dtype=torch.float32,
                         device=cuda_device)
        products = kernels.rbf_block.launches
        prepasses = kernels.rbf_split.launches
        kernels.rbf_block(X, X[:100].contiguous(), 0.01)
        torch.cuda.synchronize()
        assert kernels.rbf_block.launches == products + 1
        assert kernels.rbf_split.launches == prepasses + 2


def _rbf_fit_block(device, m=4096, n=2048, d=2048, seed=7):
    """X (m, d) standardized, Yb = n of its rows, and their indices."""
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                     device=device)
    ids = torch.tensor(rng.permutation(m)[:n], device=device)
    return X, X[ids].contiguous(), ids


@pytest.mark.cuda
def test_cuda_rbf_block_diagonal_at_fit_width(cuda_device):
    """A fit block's geometry (2048 features, 2048 of X's rows, gamma
    2e-3): every diagonal entry, where x2 + y2 − 2xy cancels over 2048
    terms, is within 5e-5 of 1, and the block within 5e-5 of its plain
    version."""
    X, Yb, ids = _rbf_fit_block(cuda_device)
    got = kernels.rbf_block(X, Yb, 2e-3)
    torch.cuda.synchronize()
    diag = got[ids, torch.arange(len(ids), device=cuda_device)]
    assert float(diag.min()) >= 1.0 - 5e-5
    want = kernels.rbf_block_reference(X, Yb, 2e-3)
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,gamma", [
    (300, 257, 440, 0.01),
    (1000, 2048, 2048, 2e-3),
])
def test_cuda_tf32_reads_raw_fp32_as_its_truncation(cuda_device, m, n, d,
                                                    gamma):
    """The kernel with X and Yb as their own hi parts and with hi written
    by the prepass (bits & 0xffffe000) gives the same bits: the tensor
    cores read a raw fp32 value as its TF32 truncation, which the aligned
    path relies on."""
    rng = np.random.default_rng(8)
    X = torch.tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                     device=cuda_device)
    Y = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                     device=cuda_device)
    for Yb in (Y, X[:min(m, n)].contiguous()):
        before = kernels.rbf_block.launches
        raw = kernels._rbf_block_cuda(X, Yb, gamma, write_hi=False)
        written = kernels._rbf_block_cuda(X, Yb, gamma, write_hi=True)
        torch.cuda.synchronize()
        assert kernels.rbf_block.launches == before + 2
        assert torch.equal(raw, written)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,offset", [
    (70, 50, 0),       # rows not a multiple of 4 floats: padded stride
    (300, 440, 0),     # aligned rows: float4 loads and stores
    (33, 2048, 0),
    (129, 440, 1),     # one float off a 16-byte boundary
])
def test_cuda_rbf_split_matches_torch(cuda_device, m, d, offset):
    """The prepass's lo (and hi, where it writes one) equal torch's bit
    mask and difference (`tf32_split`) bit for bit, and its norms torch's
    sum of squares to fp32 summation order. It writes hi exactly where X
    cannot serve as its own hi part."""
    rng = np.random.default_rng(9)
    flat = torch.tensor(rng.normal(size=m * d + offset),
                        dtype=torch.float32, device=cuda_device)
    X = flat[offset:].view(m, d)
    before = kernels.rbf_split.launches
    hi, lo, x2 = kernels.rbf_split(X)
    torch.cuda.synchronize()
    assert kernels.rbf_split.launches == before + 1
    want_hi, want_lo = kernels.tf32_split(X)
    assert torch.equal(lo, want_lo)
    assert (hi is None) == (d % 4 == 0 and offset == 0)
    assert hi is None or torch.equal(hi, want_hi)
    torch.testing.assert_close(x2, (X * X).sum(dim=1), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_rbf_block_unaligned_rows(cuda_device):
    """X one float off a 16-byte boundary cannot serve as its own hi (TMA
    needs aligned rows): the prepass writes hi, and the block still
    matches its plain version."""
    m, n, d = 130, 70, 440
    rng = np.random.default_rng(10)
    flat = torch.tensor(rng.normal(size=m * d + 1), dtype=torch.float32,
                        device=cuda_device)
    X = flat[1:].view(m, d)
    assert X.data_ptr() % 16 != 0
    for Yb in (X[:n].contiguous(), X[:n].clone()):
        got = kernels.rbf_block(X, Yb, 0.01)
        torch.cuda.synchronize()
        want = kernels.rbf_block_reference(X, Yb, 0.01)
        assert float((got - want).abs().max()) <= 5e-5


def _k4_check(got, want):
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# (statics, item shape, pixel scale, rows) of the redesigned K4's edges:
# LinearPixels at its full microbatch and below the persistent grid; rows
# whose length is not a multiple of 4, a warp a row (105 in, 35 out; 1023
# without a GrayScaler) and the block a row (3267 in, 1089 out; 1025
# with a NormalizeRows); short rows (35 floats) that share a step, at a
# count that is not a multiple of the rows per step; and the
# Fisher-vector tail at KeystoneML's VOC width, 2 x 256 centres x 64 PCA
# dims = 32,768 floats a row, which fits shared memory once
_LP = (("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",))
_FV = (("SignedHellingerMapper",), ("NormalizeRows",))
K4_EDGES = {
    "linear_pixels_4096": (_LP, (32, 32, 3), 255.0, 4096),
    "linear_pixels_5": (_LP, (32, 32, 3), 255.0, 5),
    "gray_len_105": (_LP, (7, 5, 3), 255.0, 333),
    "hellinger_len_1023": (_FV, (1023,), 1.0, 77),
    "hellinger_len_1025": (_FV, (1025,), 1.0, 77),
    "gray_33x33": (_LP, (33, 33, 3), 255.0, 129),
    "short_rows_35": (_FV, (5, 7), 1.0, 1001),
    "fisher_tail_32768": (_FV, (32_768,), 1.0, 300),
}


def _k4_inputs(name, device, pad_rows=0):
    statics, item, scale, n = K4_EDGES[name]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n + pad_rows,) + item) * scale
    x = torch.tensor(np.abs(x) if scale > 1.0 else x, dtype=torch.float32,
                     device=device)
    params = [(1e-3,) if s == ("NormalizeRows",) else () for s in statics]
    return statics, params, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K4_EDGES))
def test_cuda_elementwise_chain_edges(cuda_device, name):
    """The redesigned K4 at its edges against its plain version, 1e-6 of
    scale: one launch each, through the public wrapper."""
    from keystone_tpu_torch.ops import chain_kernels

    statics, params, x = _k4_inputs(name, cuda_device)
    before = chain_kernels.elementwise_chain.launches
    got = chain_kernels.elementwise_chain(statics, params, x)
    torch.cuda.synchronize()
    assert chain_kernels.elementwise_chain.launches == before + 1
    _k4_check(got, chain_kernels.elementwise_chain_reference(statics, params,
                                                             x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gray_len_105", "hellinger_len_1023",
                                  "hellinger_len_1025", "gray_33x33",
                                  "short_rows_35"])
def test_cuda_elementwise_chain_unaligned_base(cuda_device, name):
    """Rows of an odd length sliced from their second row: the base
    pointer is not 16-byte aligned, so steps copy their head and tail
    with plain loads and read their rows a float at a time, in a warp a
    row and in the block a row."""
    from keystone_tpu_torch.ops import chain_kernels

    statics, params, big = _k4_inputs(name, cuda_device, pad_rows=1)
    x = big[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = chain_kernels.elementwise_chain(statics, params, x)
    torch.cuda.synchronize()
    _k4_check(got, chain_kernels.elementwise_chain_reference(statics, params,
                                                             x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linear_pixels_4096", "gray_len_105",
                                  "gray_33x33", "hellinger_len_1025",
                                  "fisher_tail_32768"])
def test_cuda_elementwise_chain_writes_into_a_slice(cuda_device, name):
    """``out`` as rows of a larger tensor, at an odd row: the kernel
    writes those rows and leaves the rows on either side untouched."""
    from keystone_tpu_torch.ops import chain_kernels

    statics, params, x = _k4_inputs(name, cuda_device)
    n = x.shape[0]
    plan = chain_kernels.ChainPlan(statics, params, x.shape[1:], cuda_device)
    big = torch.full((n + 4,) + plan.out_shape, 7.0, device=cuda_device)
    got = plan(x, None, big[1:n + 1])
    torch.cuda.synchronize()
    assert got.data_ptr() == big[1:n + 1].data_ptr()
    _k4_check(big[1:n + 1], chain_kernels.elementwise_chain_reference(
        statics, params, x))
    assert bool((big[0] == 7.0).all()) and bool((big[n + 1:] == 7.0).all())


# (statics, item shape, segments) of rows too long for shared memory,
# cut along their leading axes (`chain_kernels.row_segments`): VOC's
# PixelScaler >> GrayScaler on a 500x333 image (333 segments of 1,500
# floats), the same with its gray stage masked as a padded chunk's
# stage is, LinearPixels' chain vectorizing such an image, and a
# 200x300 image (200 segments of 900 floats)
K4_SEGMENTED = {
    "voc_gray_333x500": ((("PixelScaler",), ("GrayScaler",)),
                         (333, 500, 3), 333),
    "voc_gray_masked": ((("PixelScaler",), (("GrayScaler",), "masked")),
                        (333, 500, 3), 333),
    "linear_pixels_333x500": (_LP, (333, 500, 3), 333),
    "gray_200x300": ((("PixelScaler",), ("GrayScaler",)), (200, 300, 3),
                     200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("masked_rows", [0, 3])
@pytest.mark.parametrize("name", sorted(K4_SEGMENTED))
def test_cuda_elementwise_chain_in_segments(cuda_device, name, masked_rows):
    """A row cut into segments, one kernel row each: against the plain
    version, 1e-6 of scale, with and without masked rows (the mask
    repeated for each segment), in one launch."""
    from keystone_tpu_torch.ops import chain_kernels

    statics, item, segments = K4_SEGMENTED[name]
    params = [()] * len(statics)
    n = 7
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.uniform(0, 255, size=(n,) + item),
                     dtype=torch.float32, device=cuda_device)
    mask = None
    if masked_rows:
        mask = torch.arange(n, device=cuda_device) < n - masked_rows
    plan = chain_kernels.ChainPlan(statics, params, item, cuda_device)
    assert plan.segments == segments
    before = chain_kernels.elementwise_chain.launches
    got = plan(x, mask)
    torch.cuda.synchronize()
    assert chain_kernels.elementwise_chain.launches == before + 1
    want = chain_kernels.elementwise_chain_reference(statics, params, x, mask)
    _k4_check(got, want)
    if masked_rows and name == "voc_gray_masked":
        assert float(got[n - masked_rows:].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_linear_pixels_transformer_reuses_its_plan(cuda_device):
    """LinearPixels' transformer over 9,000 images (microbatches of
    4096, the last ragged), applied twice: one plan, three launches an
    apply, each into its rows of the result, equal to the plain
    version."""
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer
    from keystone_tpu_torch.ops import chain_kernels

    statics, params, _ = _k4_inputs("linear_pixels_5", cuda_device)
    x = torch.tensor(np.random.default_rng(6).random(size=(9000, 32, 32, 3))
                     * 255.0, dtype=torch.float32, device=cuda_device)
    fbt = FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                 ImageVectorizer()], microbatch=4096)
    before = chain_kernels.elementwise_chain.launches
    for _ in range(2):
        got = fbt.batch_fn()(x)
    torch.cuda.synchronize()
    assert chain_kernels.elementwise_chain.launches == before + 6
    assert len(fbt._chain[1].plans) == 1
    _k4_check(got, chain_kernels.elementwise_chain_reference(statics, params,
                                                             x))


# ---- chains captured as CUDA graphs ------------------------------------------


def _k1_featurizer(device, k=64, microbatch=512):
    """RandomPatchCifar's featurizer (K1 after the peephole) with random
    filters and an identity whitener, at a narrow bank."""
    from keystone_tpu_torch.nodes.images.core import (
        Convolver,
        ImageVectorizer,
        PixelScaler,
        Pooler,
        SymmetricRectifier,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    filters = torch.tensor(np.random.default_rng(7).normal(
        size=(k, 6 * 6 * 3)), dtype=torch.float32, device=device) / 10.0
    return FusedBatchTransformer([
        PixelScaler(),
        Convolver(filters, 32, 32, 3, normalize_patches=True),
        SymmetricRectifier(alpha=0.25),
        Pooler(13, 14, pool_fn="sum"),
        ImageVectorizer(),
    ], microbatch=microbatch)


def _k4_featurizer(microbatch=512):
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    return FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                  ImageVectorizer()], microbatch=microbatch)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k1", "k4"])
def test_cuda_megafused_chain_replays_its_capture(cuda_device, which):
    """A megafused chain over a K1 or a K4 featurizer at the rung of
    1,100 rows (3 trips of 512): the first call runs the padded loop
    eagerly, the second captures it (its eager run is its result), later
    calls replay. Every call adds 3 launches, 3 trips and 3 microbatches
    to the counters, and its rows equal the eager chain's, for 1,100
    rows and for 1,030 rows on the same rung (a smaller tail of phantom
    rows)."""
    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
    )
    from keystone_tpu_torch.ops import chain_kernels

    featurizer = (_k1_featurizer(cuda_device) if which == "k1"
                  else _k4_featurizer())
    counter = (kernels.conv_rectify_pool if which == "k1"
               else chain_kernels.elementwise_chain)
    mega = MegafusedBatchTransformer([featurizer], microbatch=512)
    eager = featurizer.batch_fn()
    fn = mega.batch_fn()
    rng = np.random.default_rng(8)
    captures0 = _metric("megafusion.graph_captures")
    for call, n in enumerate((1100, 1030, 1100, 1030)):
        x = torch.tensor(rng.random(size=(n, 32, 32, 3)) * 255.0,
                         dtype=torch.float32, device=cuda_device)
        want = eager(x)
        launches, replays = counter.launches, _metric(
            "megafusion.graph_replays")
        trips, inner = (_metric("megafusion.scan_trips"),
                        featurizer.microbatches_run)
        got = fn(x)
        torch.cuda.synchronize()
        assert counter.launches - launches == 3
        assert _metric("megafusion.graph_captures") - captures0 == (
            0 if call == 0 else 1)
        assert _metric("megafusion.graph_replays") - replays == (
            1 if call >= 2 else 0)
        assert _metric("megafusion.scan_trips") - trips == 3
        assert featurizer.microbatches_run - inner == 3
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert _metric("megafusion.graph_captures") - captures0 == 1
    assert len(mega._graphs) == 1


@pytest.mark.cuda
def test_cuda_warmup_capture_races_an_eager_force(cuda_device):
    """A warm-up thread captures a megafused K4 chain while the main
    thread forces the same featurizer eagerly at the same item shape:
    one launch plan is built and kept, the replays equal the eager rows
    after the allocator has reused freed memory, and the graph is freed
    with its transformer (no reference cycle holds it)."""
    import threading
    import weakref

    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
    )

    rng = np.random.default_rng(11)
    x = torch.tensor(rng.random(size=(700, 32, 32, 3)) * 255.0,
                     dtype=torch.float32, device=cuda_device)
    for _ in range(3):
        featurizer = _k4_featurizer()
        mega = MegafusedBatchTransformer([featurizer], microbatch=512)
        errors = []
        captures0 = _metric("megafusion.graph_captures")
        replays0 = _metric("megafusion.graph_replays")

        def warm():
            try:
                mega.warmup((32, 32, 3), torch.float32, 700, cuda_device)
            except BaseException as e:  # re-raised below
                errors.append(e)

        t = threading.Thread(target=warm)
        t.start()
        want = featurizer.batch_fn()(x)
        t.join(timeout=120.0)
        assert not t.is_alive() and not errors
        assert len(featurizer._chain[1].plans) == 1
        junk = [torch.rand((1 << 20,), device=cuda_device)
                for _ in range(8)]
        for _ in range(2):
            got = mega.batch_fn()(x)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert _metric("megafusion.graph_captures") - captures0 == 1
        assert _metric("megafusion.graph_replays") - replays0 == 2
        ref = weakref.ref(mega)
        del mega, junk, warm
        assert ref() is None


@pytest.mark.cuda
def test_cuda_megafused_warmup_captures_without_counting(cuda_device):
    """A warm-up captures the rung's graph and counts no launch; the
    first call after it replays (no capture)."""
    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
    )
    from keystone_tpu_torch.ops import chain_kernels

    mega = MegafusedBatchTransformer([_k4_featurizer()], microbatch=512)
    before = chain_kernels.elementwise_chain.launches
    captures0 = _metric("megafusion.graph_captures")
    replays0 = _metric("megafusion.graph_replays")
    mega.warmup((32, 32, 3), torch.float32, 700, cuda_device)
    torch.cuda.synchronize()
    assert chain_kernels.elementwise_chain.launches == before
    assert _metric("megafusion.graph_captures") - captures0 == 1
    x = torch.rand((700, 32, 32, 3), device=cuda_device) * 255.0
    mega.batch_fn()(x)
    assert _metric("megafusion.graph_captures") - captures0 == 1
    assert _metric("megafusion.graph_replays") - replays0 == 1
    assert chain_kernels.elementwise_chain.launches == before + 2


@pytest.mark.cuda
def test_cuda_megafused_capture_failure_raises(cuda_device):
    """A chain that synchronizes cannot be captured: its first call runs
    eagerly, the second (which captures) raises, and no eager result
    stands in for the graph."""
    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
    )
    from keystone_tpu_torch.workflow.pipeline import Transformer

    class _Syncs(Transformer):
        fusable = True

        def batch_fn(self):
            return lambda x: x * float(x.sum().item() * 0.0 + 1.0)

    mega = MegafusedBatchTransformer([_Syncs()], microbatch=64)
    x = torch.ones((10, 4), device=cuda_device)
    captures0 = _metric("megafusion.graph_captures")
    mega.batch_fn()(x)
    with pytest.raises(RuntimeError):
        mega.batch_fn()(x)
    assert _metric("megafusion.graph_captures") == captures0
    assert not mega._graphs


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_host_stream_matches_per_item(cuda_device, overlap):
    """Host images through `map_host_batched_stream` on the card, overlap
    off and on, megafusion off: each chunk's rows equal the chain on the
    items one by one; overlapped, the pinned ring holds at most
    depth + 1 chunks."""
    from keystone_tpu_torch.utils import batching
    from keystone_tpu_torch.workflow.env import config_override

    rng = np.random.default_rng(9)
    items = [rng.random(size=(32, 32, 3)).astype(np.float32) * 255.0
             for _ in range(700)]
    fn = _k4_featurizer().batch_fn()
    pinned = _peak_pinned()
    with config_override(overlap=overlap, megafusion=False,
                         prefetch_depth=2):
        out = batching.map_host_batched(items, fn, chunk=128,
                                        device=cuda_device)
    torch.cuda.synchronize()
    want = fn(torch.tensor(np.stack(items), device=cuda_device))
    torch.testing.assert_close(torch.stack(out), want, rtol=0, atol=0)
    peak = pinned.max
    chunk_bytes = 128 * items[0].nbytes
    assert (0 < peak <= 3 * chunk_bytes) if overlap else peak == 0


@pytest.mark.cuda
def test_cuda_host_megafused_stream_is_one_replay(cuda_device):
    """A fused chain's batch function over 700 host images at chunk 128
    (6 chunks, the tail padded), overlap on: the first stream runs the
    padded loop eagerly, the second captures it, the third is one replay
    of the one graph; each launches 6 times and its rows equal the eager
    chain's. The group goes through the pinned ring (one buffer of the 6
    chunks)."""
    from keystone_tpu_torch.ops import chain_kernels
    from keystone_tpu_torch.utils import batching
    from keystone_tpu_torch.workflow.env import config_override

    rng = np.random.default_rng(10)
    items = [rng.random(size=(32, 32, 3)).astype(np.float32) * 255.0
             for _ in range(700)]
    fbt = _k4_featurizer()
    fn = fbt.batch_fn()
    want = fn(torch.tensor(np.stack(items), device=cuda_device))
    captures0 = _metric("megafusion.graph_captures")
    trips0 = _metric("megafusion.scan_trips")
    for call in range(3):
        before = chain_kernels.elementwise_chain.launches
        replays = _metric("megafusion.graph_replays")
        pinned = _peak_pinned()
        with config_override(megafusion=True, pad_chunks=True, overlap=True):
            out = batching.map_host_batched(items, fn, chunk=128,
                                            device=cuda_device)
        torch.cuda.synchronize()
        assert chain_kernels.elementwise_chain.launches - before == 6
        assert _metric("megafusion.graph_captures") - captures0 == (
            0 if call == 0 else 1)
        assert _metric("megafusion.graph_replays") - replays == (
            1 if call == 2 else 0)
        assert pinned.max == 6 * 128 * items[0].nbytes
        torch.testing.assert_close(torch.stack(out), want, rtol=0, atol=0)
    assert _metric("megafusion.scan_trips") - trips0 == 18


@pytest.mark.cuda
def test_cuda_decode_flags_the_entries_the_cpu_flags(cuda_device):
    """`decode_jpeg_batch` for the card: the committed VOC tar with one
    entry corrupted and one malformed (its SOF0 marker made SOF2: a
    progressive frame whose scan is a baseline one) gives the CPU's
    decode, pixel for pixel, on the card: both entries None and left out
    of ``ok``, the others equal."""
    import pathlib

    from keystone_tpu_torch.utils import native_io

    res = pathlib.Path(__file__).resolve().parent / "resources"
    buf = bytearray((res / "voc_mini.tar").read_bytes())
    entries = [(o, s) for _, o, s in native_io.tar_index(bytes(buf))]
    off, _ = entries[1]
    buf[off + 2:off + 40] = b"\0" * 38
    off, size = entries[2]
    sof = bytes(buf[off:off + size]).index(b"\xff\xc0")
    buf[off + sof + 1] = 0xC2
    got, ok = native_io.decode_jpeg_batch(bytes(buf), entries, cuda_device)
    want, ok_cpu = native_io.decode_jpeg_batch(bytes(buf), entries, "cpu")
    assert ok == ok_cpu == len(entries) - 2
    assert [g is None for g in got] == [w is None for w in want] == \
        [False, True, True] + [False] * (len(entries) - 3)
    for g, w in zip(got, want):
        if g is not None:
            assert g.device.type == "cuda" and g.dtype == torch.float32
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_chain_kernel_span_covers_the_kernel(cuda_device):
    """A traced call of a chain that runs its planned K4 records one
    ``chain_kernel`` span, which waits for the card before it closes: its
    duration is at least the kernel's own time between CUDA events. So
    does a traced graph replay of the chain's padded loop, an eager
    padded loop of several trips (one span for the call, not one a
    trip), and a megafused chain around it (one span a call, none of
    the nested chain's; the capturing call's span is its eager run
    before the capture). An untraced call records none and makes no
    synchronizing call for one."""
    from keystone_tpu_torch.ops import chain_kernels
    from keystone_tpu_torch.telemetry import to_chrome_trace, trace_run

    fbt = _k4_featurizer()
    assert fbt.planned_kernel is not None
    x = torch.rand((8192, 32, 32, 3), device=cuda_device) * 255.0
    fn = fbt.batch_fn()
    fn(x)  # plans and the kernel's load
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(x)
    end.record()
    end.synchronize()
    kernel_s = start.elapsed_time(end) / 1e3
    with trace_run() as tracer:
        before = chain_kernels.elementwise_chain.launches
        fn(x)
        launched = chain_kernels.elementwise_chain.launches - before
        trace = to_chrome_trace(tracer)
    spans = [e for e in trace["traceEvents"]
             if e.get("name") == "chain_kernel"]
    assert launched >= 1 and len(spans) == 1
    assert spans[0]["args"]["rows"] == 8192
    assert spans[0]["dur"] / 1e6 >= 0.9 * kernel_s, (spans, kernel_s)

    # a replayed padded loop: the span wraps the replay
    rows = x[:1000]
    for _ in range(2):  # the eager call, then the capture
        fbt.run_rung(rows, 1024, 1024)
    with trace_run() as tracer:
        fbt.run_rung(rows, 1024, 1024)
        trace = to_chrome_trace(tracer)
    assert len([e for e in trace["traceEvents"]
                if e.get("name") == "chain_kernel"]) == 1

    # an eager padded loop of four 256-row trips: one span for the call
    with trace_run() as tracer:
        fbt.run_rung(rows, 1024, 256)
        trace = to_chrome_trace(tracer)
    assert len([e for e in trace["traceEvents"]
                if e.get("name") == "chain_kernel"]) == 1

    # a megafused chain over it: one span a call, eager or replayed, and
    # none of the nested chain's inside it
    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
    )

    mega = MegafusedBatchTransformer([fbt], microbatch=512)
    mfn = mega.batch_fn()
    for call in range(3):  # eager, capture, replay
        with trace_run() as tracer:
            mfn(rows)
            trace = to_chrome_trace(tracer)
        assert len([e for e in trace["traceEvents"]
                    if e.get("name") == "chain_kernel"]) == 1, call

    # untraced: no span and no sync for one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")



@pytest.mark.cuda
def test_cuda_crf_objective_and_viterbi_match_the_cpu(cuda_device):
    """The CRF on the card computes the CPU path's function: at the same
    numpy-seeded theta the NLL and its gradient in float64 agree to 1e-9
    (float32 within 1e-5 of the value and 1e-4 of max|gradient|), and a
    short fit's weights decode to the same tags on both devices (the
    decode's ties broken at the first maximal index on both)."""
    from keystone_tpu_torch.nodes.nlp import (
        LinearChainCRFTagger,
        generate_pos_corpus,
    )

    corpus = generate_pos_corpus(240, seed=4)
    train, test = corpus[:200], corpus[200:]
    card = LinearChainCRFTagger(n_buckets=1 << 12, max_iter=15,
                                device=cuda_device)
    cpu = LinearChainCRFTagger(n_buckets=1 << 12, device="cpu")
    card_obj, cpu_obj = card.objective(train), cpu.objective(train)
    theta = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        cpu_obj.size)).astype(np.float32))
    for dtype, vtol, gtol in ((torch.float64, 1e-9, 1e-9),
                              (torch.float32, 1e-5, 1e-4)):
        v, g = card_obj(theta.to(cuda_device, dtype))
        want_v, want_g = cpu_obj(theta.to(dtype))
        assert abs(float(v) - float(want_v)) <= vtol * abs(float(want_v))
        err = float((g.cpu() - want_g).abs().max())
        assert err <= gtol * float(want_g.abs().max()), (dtype, err)
    card.train(train)
    assert 0 < len(card.loss_history) <= 15
    cpu.set_theta(card.theta.cpu())
    tokens = [[w for w, _ in s] for s in test] + [[], ["the"]]
    assert card.predict_batch(tokens) == cpu.predict_batch(tokens)


@pytest.mark.cuda
def test_cuda_replays_hold_while_their_thread_captures(cuda_device):
    """Replays of graphs captured on this thread stay bit for bit while
    this thread captures new loops of the same products (a hot swap's
    pattern; `serving/capture_race.py`). With the eager runs before each
    capture on the capture stream, a replay read a product's cuBLAS
    workspace as another wrote it: 1 wrong in 1,554 replays at 2048×10
    and 3 in 5,747 at 40960×20 (H100, 700 W)."""
    from keystone_tpu_torch.serving.capture_race import capture_race

    report = capture_race(3.0, shapes=((2048, 10), (40960, 20)),
                          device=cuda_device)
    assert all(s["replays"] > 0 and s["ladders_captured"] > 0
               for s in report["shapes"])
    assert report["wrong"] == 0, report


@pytest.fixture
def nccl_group(cuda_device):
    """An NCCL group of world size 1 on the card (a free localhost port,
    a 60 s timeout), destroyed after the test."""
    import socket

    import torch.distributed as dist

    from keystone_tpu_torch import parallel

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert parallel.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda",
                                   timeout=60) == 1
    try:
        yield parallel.global_data_mesh()
    finally:
        parallel.reset_default_mesh()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_nccl_collectives_at_world_one(nccl_group):
    """The data axis on the card: NCCL's all-reduce, all-gather and
    broadcast at world size 1 (each an identity), and a mesh `Dataset`'s
    rows gathered back, held to the plain arrays."""
    import torch.distributed as dist

    from keystone_tpu_torch import parallel
    from keystone_tpu_torch.data.dataset import Dataset

    assert dist.get_backend() == "nccl"
    mesh = nccl_group
    assert parallel.n_data_shards(mesh) == 1
    x = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    ds = Dataset.from_numpy(x, mesh=mesh)
    assert ds.device.type == "cuda" and ds.count == ds.padded_count == 64
    np.testing.assert_array_equal(parallel.tree_reduce_sum(ds).cpu().numpy(),
                                  x.sum(axis=0))
    np.testing.assert_array_equal(
        parallel.all_gather_rows(ds).cpu().numpy(), x)
    w = torch.full((4, 4), 3.0, device="cuda")
    np.testing.assert_array_equal(parallel.broadcast(w, mesh).cpu().numpy(),
                                  np.full((4, 4), 3.0, np.float32))
    np.testing.assert_array_equal(ds.numpy(), x)
    odd = Dataset.from_numpy(x[:63], mesh=mesh)
    np.testing.assert_array_equal(odd.numpy(), x[:63])
    local = parallel.dataset_from_process_local(x, mesh=mesh)
    assert local.device.type == "cuda" and local.count == 64
    np.testing.assert_array_equal(local.numpy(), x)


@pytest.mark.cuda
def test_cuda_planned_chain_kernel_takes_the_row_mask(nccl_group):
    """A chain that K4 plans, its scaler the run's last stage, on the
    card: over a mesh `Dataset` through `apply_batch`, and over rows
    with padded ones and their mask, as `apply_batch` passes a rank's
    (eagerly, and megafused: its eager call, its capture and a replay).
    Each call launches K4 once a 128-row microbatch, the mask goes into
    the kernel, and the rows are its plain version's with the mask,
    padded rows zero. An NCCL group of one card pads no row, so the mask
    is passed here; the gloo tests run the padded mesh path itself."""
    from keystone_tpu_torch.data.dataset import Dataset
    from keystone_tpu_torch.nodes.util.fusion import (
        MegafusedBatchTransformer,
        stage_fuse,
    )
    from keystone_tpu_torch.ops import chain_kernels

    import torch_parallel_worker as worker

    chain = worker.k4_chain()
    assert chain.planned_kernel == (0, 4, "elementwise_chain")
    fused = [stage_fuse(s) for s in chain.fused]
    statics, params = [f[0] for f in fused], [f[1] for f in fused]
    x = torch.from_numpy(worker.k4_images()[:300]).cuda()
    mask = torch.arange(300, device="cuda") < 295

    def launched(fn):
        before = chain_kernels.elementwise_chain.launches
        out = fn()
        torch.cuda.synchronize()
        assert chain_kernels.elementwise_chain.launches - before == 3
        return out

    got = launched(lambda: chain.apply_batch(Dataset(x, mesh=nccl_group)))
    _k4_check(got.array, chain_kernels.elementwise_chain_reference(
        statics, params, x))
    want = chain_kernels.elementwise_chain_reference(statics, params, x,
                                                     mask)
    got = launched(lambda: chain.batch_fn()(x, mask))
    _k4_check(got, want)
    assert float(got[295:].abs().max()) == 0.0
    mega = MegafusedBatchTransformer([chain], microbatch=128).batch_fn()
    for _ in range(3):
        got = launched(lambda: mega(x, mask))
        _k4_check(got, want)
        assert float(got[295:].abs().max()) == 0.0
