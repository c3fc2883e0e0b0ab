"""The port's chain kernels against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through JAX's
`elementwise_chain_pallas` (interpret mode, ``block_n=4`` so every
ragged count pads a tail block) and `elementwise_chain_reference`, and
through the port's `elementwise_chain_reference`, which is the plain
version of the CUDA kernel. The stage table the CUDA kernel is given
(`chain_layout`) is interpreted here in numpy as the kernel reads it, so
its offsets, broadcast periods, norm passes and slot sizes are checked
without a card. Also: the matcher's verdicts, the nodes' static keys, and the
routing of `FusedBatchTransformer` through the chain kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.images.core import (
    GrayScaler as JaxGrayScaler,
    ImageVectorizer as JaxImageVectorizer,
    PixelScaler as JaxPixelScaler,
    Pooler as JaxPooler,
    SymmetricRectifier as JaxSymmetricRectifier,
)
from keystone_tpu.ops import chain_kernels as jck
from keystone_tpu_torch.nodes.images.core import (
    Convolver,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    Pooler,
    SymmetricRectifier,
)
from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    stage_statics,
)
from keystone_tpu_torch.ops import chain_kernels as ck
from keystone_tpu_torch.ops import kernels

RNG_SEED = 7


def _linear_pixels_chain(rng):
    """The LinearPixels trail on (8, 8, 3) pixel rows."""
    statics = (("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",))
    return statics, [(), (), ()], (8, 8, 3), 255.0


def _every_other_head_chain(rng):
    """Every remaining head on (8, 16) rows: signs broadcast along the
    last axis of 16, the scalers along the 128 of the flat row; the
    scale form is masked."""
    statics = (
        ("LinearRectifier",), ("RandomSignNode",), ("SignedHellingerMapper",),
        ("NormalizeRows",), ("MatrixVectorizer",),
        (("StandardScaler", "scale"), "masked"), ("StandardScaler", "center"),
    )
    params = [
        (np.float64(-0.3), np.float64(0.1)),
        (rng.choice([-1.0, 1.0], size=16).astype(np.float32),),
        (),
        (np.float64(1e-3),),
        (),
        (rng.normal(size=128).astype(np.float32),
         rng.uniform(0.5, 2.0, size=128).astype(np.float32)),
        (rng.normal(size=128).astype(np.float32),),
    ]
    return statics, params, (8, 16), 1.0


def _one_channel_chain(rng):
    """GrayScaler on one channel (the identity), then a masked scaler
    whose key carries no form (the scale form, as in JAX)."""
    statics = (("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",),
               (("StandardScaler",), "masked"))
    params = [(), (), (), (rng.normal(size=36).astype(np.float32),
                           rng.uniform(0.5, 2.0, size=36).astype(np.float32))]
    return statics, params, (6, 6, 1), 255.0


CHAINS = {"linear_pixels": _linear_pixels_chain,
          "every_other_head": _every_other_head_chain,
          "one_channel": _one_channel_chain}


def _inputs(chain, n, masked_rows):
    rng = np.random.default_rng(RNG_SEED)
    statics, params, item, scale = CHAINS[chain](rng)
    x = (rng.normal(size=(n,) + item) * scale).astype(np.float32)
    if scale > 1.0:
        x = np.abs(x)
    mask = None
    if masked_rows:
        mask = np.arange(n) < n - masked_rows
    return statics, params, x, mask


def _port(statics, params, x, mask):
    return ck.elementwise_chain_reference(
        statics, params, torch.from_numpy(x),
        None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("n,masked_rows", [(3, 0), (11, 0), (37, 0),
                                           (11, 4), (37, 5)])
def test_elementwise_chain_reference_matches_jax(chain, n, masked_rows):
    """Every registered head, raw static keys, ragged counts, with and
    without a row mask: the port's plain version against JAX's kernel in
    interpret mode and JAX's reference, within 1e-6 (the JAX interpret
    test's limit, tests/test_chain_kernels.py:128)."""
    statics, params, x, mask = _inputs(chain, n, masked_rows)
    jmask = None if mask is None else jnp.asarray(mask)
    want_kernel = np.asarray(jck.elementwise_chain_pallas(
        statics, params, jnp.asarray(x), jmask, block_n=4, interpret=True))
    want_ref = np.asarray(jck.elementwise_chain_reference(
        statics, params, jnp.asarray(x), jmask))
    got = _port(statics, params, x, mask)
    assert got.shape == want_kernel.shape == want_ref.shape
    np.testing.assert_allclose(got, want_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_ref, rtol=1e-6, atol=1e-6)
    if mask is not None and ck._unwrap(statics[-1])[1]:
        assert np.all(got[~mask] == 0.0)


def _emulate(layout, x, mask):
    """The CUDA kernel's reading of a `ChainLayout`, in numpy: the rows
    of a step held in the block's slot of ``launch.slot_bytes``; for each
    NormalizeRows a pass that runs the stages before it from the row as
    loaded and sums the squares, then a pass through every stage that
    divides by the denominators found; stage codes applied in order,
    vectors read at ``offs[s] + e % lasts[s]``."""
    n = x.shape[0]
    rows = x.reshape(n, -1).astype(np.float32)
    launch = layout.launch
    assert launch.rows * rows.shape[1] * 4 + 16 <= launch.slot_bytes
    assert launch.slot_bytes % 16 == 0
    packed = layout.packed.numpy()
    m = (np.ones(n, np.float32) if mask is None
         else mask.astype(np.float32))[:, None]

    def run(stop, denoms):
        cur, k = rows, 0
        for s in range(stop):
            code = layout.codes[s]
            length, last = layout.lens[s], layout.lasts[s]
            assert cur.shape[1] == length
            idx = np.arange(length) % last
            vec = packed[layout.offs[s]:]
            if code == 1 and last == 3:
                cur = (cur[:, 0::3] * np.float32(0.299)
                       + cur[:, 1::3] * np.float32(0.587)
                       + cur[:, 2::3] * np.float32(0.114))
            elif code == 0:
                cur = cur / np.float32(255.0)
            elif code == 3:
                cur = np.maximum(np.float32(layout.s0[s]),
                                 cur - np.float32(layout.s1[s]))
            elif code == 4:
                cur = cur / denoms[k]
                k += 1
            elif code == 5:
                cur = np.sign(cur) * np.sqrt(np.abs(cur))
            elif code == 6:
                cur = cur * vec[idx]
            elif code == 7:
                cur = (cur - vec[idx]) / vec[last + idx]
            elif code == 8:
                cur = cur - vec[idx]
            if layout.masked[s]:
                cur = cur * m
        return cur

    denoms = []
    for s, code in enumerate(layout.codes):
        if code == 4:
            pre = run(s, denoms)
            denoms.append(np.maximum(
                np.sqrt((pre * pre).sum(axis=1, keepdims=True)),
                np.float32(layout.s0[s])))
    return run(len(layout.codes), denoms).reshape((n,) + layout.out_shape)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_layout_as_the_kernel_reads_it_matches_reference(chain):
    """The stage table, packed vectors and buffer sizes the wrapper hands
    the CUDA kernel, interpreted as the kernel does, give the plain
    version's result (1e-6)."""
    statics, params, x, mask = _inputs(chain, 13, 3)
    layout = ck.chain_layout(statics, params, x.shape[1:], "cpu")
    got = _emulate(layout, x, mask)
    want = _port(statics, params, x, mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_linear_pixels_layout_holds_one_row_in_shared_memory():
    """(32, 32, 3) rows: 3072 floats in, one flat (1024,) row out; a step
    is one 12 KB row, the whole block on it, in one slot of 12,304 bytes
    (the row and 16 for an unaligned start)."""
    statics = (("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",))
    layout = ck.chain_layout(statics, [(), (), ()], (32, 32, 3), "cpu")
    assert layout.lens == [3072, 3072, 1024]
    assert layout.lasts == [3, 3, 1]
    assert layout.out_shape == (1024,)
    assert layout.codes == [0, 1, 2]
    assert layout.launch == ck.ChainLaunch(
        rows=1, group=128, slot_bytes=12304,
        smem_bytes=ck.CHAIN_FIXED_SMEM + 12304)
    assert layout.packed.numel() == 0


def test_chain_layout_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        ck.chain_layout((("PixelScaler",), ("ImageVectorizer",)),
                        [(), ()], (200, 300), "cpu")
    with pytest.raises(ValueError, match="last axis"):
        ck.chain_layout((("RandomSignNode",), ("ImageVectorizer",)),
                        [(np.ones(5, np.float32),), ()], (4, 6), "cpu")
    with pytest.raises(ValueError, match="channels"):
        ck.chain_layout((("GrayScaler",), ("ImageVectorizer",)),
                        [(), ()], (4, 4, 2), "cpu")
    with pytest.raises(ValueError, match="at most"):
        ck.chain_layout((("PixelScaler",),) * (ck.MAX_STAGES + 1),
                        [()] * (ck.MAX_STAGES + 1), (4,), "cpu")
    with pytest.raises(ValueError, match="no elementwise body"):
        ck.chain_layout((("PaddedFFT",), ("PixelScaler",)), [(), ()], (4,),
                        "cpu")


def _verdict(v):
    return (v["lowerable"], v["family"], sorted(v.get("suppressed") or {}))


def test_linear_pixels_static_keys_match_jax():
    port = stage_statics([PixelScaler(), GrayScaler(), ImageVectorizer()])
    jax_ = jck.stage_statics([JaxPixelScaler(), JaxGrayScaler(),
                              JaxImageVectorizer()])
    assert port == jax_ == (("PixelScaler",), ("GrayScaler",),
                            ("ImageVectorizer",))


@pytest.mark.parametrize("trail", [
    "linear_pixels", "rectify_pool_vectorize", "padded_fft",
    "conv_rectify_pool", "single_stage", "masked_scaler",
])
def test_lowerability_verdicts_match_jax(trail):
    """The matcher's verdict (lowerable, family, suppressed stages) on
    the same trails. The FFT and conv trails go in as the JAX package's
    raw static keys: the port has no PaddedFFT node yet."""
    if trail == "linear_pixels":
        port = stage_statics([PixelScaler(), GrayScaler(),
                                 ImageVectorizer()])
        jax_ = jck.stage_statics([JaxPixelScaler(), JaxGrayScaler(),
                                  JaxImageVectorizer()])
    elif trail == "rectify_pool_vectorize":
        port = stage_statics([SymmetricRectifier(alpha=0.25),
                                 Pooler(13, 14), ImageVectorizer()])
        jax_ = jck.stage_statics([JaxSymmetricRectifier(alpha=0.25),
                                  JaxPooler(13, 14), JaxImageVectorizer()])
    elif trail == "padded_fft":
        port = jax_ = (("RandomSignNode",), ("PaddedFFT",),
                       ("LinearRectifier",))
    elif trail == "conv_rectify_pool":
        port = jax_ = (("PixelScaler",),
                       ("ConvRectifyPool", 0.25, 0.0, 14, 13, 6, True, True),
                       ("ImageVectorizer",))
    elif trail == "single_stage":
        port = jax_ = (("PixelScaler",),)
    else:
        port = jax_ = (("ImageVectorizer",),
                       (("StandardScaler", "scale"), "masked"))
    assert _verdict(ck.lowerability(port)) == _verdict(
        jck.lowerability(jax_))


@pytest.mark.parametrize("channels", [3, 1])
def test_grayscaler_matches_jax(channels):
    x = np.random.default_rng(3).random(size=(5, 8, 8, channels)).astype(
        np.float32)
    got = GrayScaler().batch_fn()(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(JaxGrayScaler().apply(jnp.asarray(xi)))
                     for xi in x])
    assert got.shape == want.shape == (5, 8, 8, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _Spy:
    """Stands in for a chain kernel wrapper and records its calls."""

    def __init__(self, real):
        self.real = real
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.real(*args)


def _stagewise(stages, x):
    for s in stages:
        x = s.batch_fn()(x)
    return x


def test_linear_pixels_trail_runs_the_elementwise_chain(monkeypatch):
    """PixelScaler >> GrayScaler >> ImageVectorizer is tagged as one
    elementwise chain and runs one chain launch per microbatch (37 rows
    in microbatches of 16: three, the last ragged), each through the
    transformer's plan and into its rows of the result."""
    calls = []
    real = ck.ChainPlan.__call__

    def spy(plan, x, mask=None, out=None):
        calls.append((plan.statics, x.shape[0], out))
        return real(plan, x, mask, out)

    monkeypatch.setattr(ck.ChainPlan, "__call__", spy)
    stages = [PixelScaler(), GrayScaler(), ImageVectorizer()]
    fbt = FusedBatchTransformer(stages, microbatch=16)
    assert fbt.planned_kernel == (0, 3, "elementwise_chain")
    x = torch.from_numpy(np.random.default_rng(0).random(
        size=(37, 8, 8, 3)).astype(np.float32) * 255.0)
    got = fbt.batch_fn()(x)
    assert [c[1] for c in calls] == [16, 16, 5]
    assert all(c[0] == (("PixelScaler",), ("GrayScaler",),
                        ("ImageVectorizer",)) for c in calls)
    assert all(c[2] is not None and c[2].shape[0] == c[1] for c in calls)
    torch.testing.assert_close(got, _stagewise(stages, x), rtol=1e-6,
                               atol=1e-6)


def test_rectify_pool_vectorize_trail_runs_k3(monkeypatch):
    """SymmetricRectifier >> Pooler(sum) >> ImageVectorizer peepholes to
    RectifyPool >> ImageVectorizer and runs `rectify_pool_vectorize`,
    one launch per microbatch."""
    spy = _Spy(ck.rectify_pool_vectorize)
    monkeypatch.setattr(ck, "rectify_pool_vectorize", spy)
    stages = [SymmetricRectifier(alpha=0.25), Pooler(5, 6, pool_fn="sum"),
              ImageVectorizer()]
    fbt = FusedBatchTransformer(stages, microbatch=4)
    assert fbt.planned_kernel == (0, 2, "rectify_pool_vectorize")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(7, 12, 12, 8)).astype(np.float32))
    got = fbt.batch_fn()(x)
    assert len(spy.calls) == 2
    torch.testing.assert_close(
        got, kernels.rectify_pool_vectorize_reference(x, 0.25, 0.0, 6, 5))


def test_random_patch_cifar_trail_is_untouched(monkeypatch):
    """[PixelScaler, ConvRectifyPool, ImageVectorizer] has no run of two
    lowerable stages: no tag, no chain kernel, K1 once per microbatch."""
    chain_spy = _Spy(ck.elementwise_chain)
    k3_spy = _Spy(ck.rectify_pool_vectorize)
    monkeypatch.setattr(ck, "elementwise_chain", chain_spy)
    monkeypatch.setattr(ck, "rectify_pool_vectorize", k3_spy)
    from keystone_tpu_torch.nodes.util import fusion

    k1_spy = _Spy(fusion.conv_rectify_pool)
    monkeypatch.setattr(fusion, "conv_rectify_pool", k1_spy)
    filters = np.random.default_rng(2).normal(size=(4, 108)).astype(
        np.float32)
    fbt = FusedBatchTransformer(
        [PixelScaler(), Convolver(filters, 32, 32, 3, device="cpu"),
         SymmetricRectifier(alpha=0.25), Pooler(13, 14, pool_fn="sum"),
         ImageVectorizer()], microbatch=4)
    assert fbt.planned_kernel is None
    x = torch.rand((9, 32, 32, 3)) * 255.0
    assert fbt.batch_fn()(x).shape == (9, 2 * 2 * 8)
    assert len(k1_spy.calls) == 3
    assert not chain_spy.calls and not k3_spy.calls


def test_masked_scaler_joins_the_chain_and_a_stale_tag_raises():
    """A StandardScalerModel after the LinearPixels trail joins the run
    (its key is masked); a tag naming a family the trail does not match,
    or stages the trail does not have, raises rather than running the
    stages one by one."""
    rng = np.random.default_rng(4)
    mean = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, size=64).astype(np.float32))
    stages = [PixelScaler(), GrayScaler(), ImageVectorizer(),
              StandardScalerModel(mean, std)]
    fbt = FusedBatchTransformer(stages, microbatch=8)
    assert fbt.planned_kernel == (0, 4, "elementwise_chain")
    x = torch.from_numpy(rng.random(size=(11, 8, 8, 3)).astype(np.float32))
    want = _stagewise(stages, x)
    torch.testing.assert_close(fbt.batch_fn()(x), want, rtol=1e-6,
                               atol=1e-6)
    fbt.planned_kernel = (0, 4, "rectify_pool_vectorize")
    with pytest.raises(ValueError, match="elementwise_chain"):
        fbt.batch_fn()
    fbt.planned_kernel = (0, 9, "elementwise_chain")
    with pytest.raises(ValueError, match="out of range"):
        fbt.batch_fn()
