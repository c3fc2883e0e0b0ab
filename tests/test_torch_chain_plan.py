"""The chain kernel's launch plan, on the CPU.

`ChainPlan` holds what every launch of a chain shares (the stage table,
the packed vectors, the scalars, the kernel's row slot and grid), and
`chain_launch_config` chooses the rows per step, the threads per row and
the slot from the row's bytes and the shared-memory budget. Here:
the plan's table against `chain_layout`'s, the chooser's choices, one
plan per `FusedBatchTransformer` and item shape however many
microbatches and applies run, and the transformer's result written into
its slices against the node-by-node result and JAX's
`elementwise_chain_pallas` in interpret mode (1e-6, the JAX interpret
test's limit, tests/test_chain_kernels.py:128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import chain_kernels as jck
from keystone_tpu_torch.nodes.images.core import (
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
)
from keystone_tpu_torch.nodes.stats.scalers import StandardScalerModel
from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer
from keystone_tpu_torch.ops import chain_kernels as ck
from keystone_tpu_torch.ops.kernels import MAX_SMEM_BYTES

LINEAR_PIXELS = (("PixelScaler",), ("GrayScaler",), ("ImageVectorizer",))


def _every_other_head(rng, d=128):
    statics = (("LinearRectifier",), ("RandomSignNode",),
               ("SignedHellingerMapper",), ("NormalizeRows",),
               (("StandardScaler", "scale"), "masked"),
               ("StandardScaler", "center"))
    params = [(np.float64(-0.3), torch.tensor(0.1, dtype=torch.float64)),
              (rng.choice([-1.0, 1.0], size=d).astype(np.float32),), (),
              (torch.tensor(1e-3),),
              (rng.normal(size=d).astype(np.float32),
               rng.uniform(0.5, 2.0, size=d).astype(np.float32)),
              (rng.normal(size=d).astype(np.float32),)]
    return statics, params


@pytest.mark.parametrize("chain", ["linear_pixels", "every_other_head"])
def test_plan_table_matches_chain_layout(chain):
    """The plan's stage table, packed vectors and scalars are
    `chain_layout`'s; its scalars are host floats (no tensor left to
    read at launch time) rounded to float32."""
    rng = np.random.default_rng(0)
    if chain == "linear_pixels":
        statics, params, item = LINEAR_PIXELS, [(), (), ()], (8, 8, 3)
    else:
        (statics, params), item = _every_other_head(rng), (128,)
    plan = ck.ChainPlan(statics, params, item, "cpu")
    want = ck.chain_layout(statics, params, item, "cpu")
    for name in ("codes", "lens", "lasts", "offs", "masked", "s0", "s1",
                 "out_shape", "launch"):
        assert getattr(plan.layout, name) == getattr(want, name), name
    torch.testing.assert_close(plan.layout.packed, want.packed)
    assert all(type(v) is float for v in plan.layout.s0 + plan.layout.s1)
    assert plan.out_shape == want.out_shape
    if chain == "every_other_head":
        assert plan.layout.s0[:4] == [float(np.float32(-0.3)), 0.0, 0.0,
                                      float(np.float32(1e-3))]
        assert plan.layout.s1[0] == float(np.float32(0.1))
        assert plan.layout.offs == [0, 0, 128, 128, 128, 384]


def test_launch_config_for_linear_pixels():
    """A 12 KB LinearPixels row: one row a step, the block on it, in one
    slot of the row and 16 bytes of slack."""
    launch = ck.chain_launch_config(32 * 32 * 3)
    assert launch == ck.ChainLaunch(
        rows=1, group=128, slot_bytes=12304,
        smem_bytes=ck.CHAIN_FIXED_SMEM + 12304)


def test_launch_config_for_a_fisher_vector_row_fits():
    """KeystoneML's VOC Fisher vector, 2 × 256 centres × 64 PCA dims =
    32,768 floats (128 KB) a row, fits the 232,448-byte budget."""
    launch = ck.chain_launch_config(2 * 256 * 64)
    assert (launch.rows, launch.group) == (1, 128)
    assert launch.smem_bytes == ck.CHAIN_FIXED_SMEM + 131072 + 16
    assert launch.smem_bytes <= MAX_SMEM_BYTES


@pytest.mark.parametrize("in_len", [58_009, 58_112, 60_000, 10**6])
def test_launch_config_refuses_a_row_that_does_not_fit(in_len):
    """A row above 232,448 bytes less the fixed part and the slot's 16
    bytes of slack (58,008 floats fit exactly) raises: no launch could
    hold it."""
    with pytest.raises(ValueError, match="shared memory"):
        ck.chain_launch_config(in_len)
    if 4 * in_len > MAX_SMEM_BYTES:
        with pytest.raises(ValueError, match="shared memory"):
            ck.chain_layout((("PixelScaler",), ("ImageVectorizer",)),
                            [(), ()], (in_len,), "cpu")


@pytest.mark.parametrize("in_len", [1, 2, 3, 5, 35, 36, 105, 128, 440,
                                    1023, 1024, 1025, 2048, 3072, 3267,
                                    4096, 12_345, 16_384, 32_767, 32_768,
                                    57_000, 58_000, 58_008])
def test_launch_config_invariants(in_len):
    """Short rows share a step of at least 16 KB with a warp a row, as
    many rows for each of the block's four warps; a slot holds its step
    and 16 bytes of slack, in multiples of 16; the slot fits the
    budget."""
    launch = ck.chain_launch_config(in_len)
    row_bytes = 4 * in_len
    if row_bytes < ck.CHAIN_SHORT_ROW_BYTES:
        warps = ck.CHAIN_THREADS // 32
        assert launch.group == 32 and launch.rows % warps == 0
        assert launch.rows * row_bytes >= ck.CHAIN_STEP_BYTES
        assert (launch.rows - warps) * row_bytes < ck.CHAIN_STEP_BYTES
    else:
        assert (launch.rows, launch.group) == (1, ck.CHAIN_THREADS)
    assert launch.slot_bytes % 16 == 0
    assert launch.slot_bytes >= launch.rows * row_bytes + 16
    assert launch.slot_bytes < launch.rows * row_bytes + 32
    assert launch.smem_bytes == ck.CHAIN_FIXED_SMEM + launch.slot_bytes
    assert launch.smem_bytes <= MAX_SMEM_BYTES


def _counting(monkeypatch):
    """Count the plans and the chain walks the transformer makes."""
    built, walks = [], []
    real_init, real_layout = ck.ChainPlan.__init__, ck.chain_layout

    def init(self, statics, params, item_shape, device):
        built.append(tuple(item_shape))
        real_init(self, statics, params, item_shape, device)

    def layout(*args, **kwargs):
        walks.append(args[2])
        return real_layout(*args, **kwargs)

    monkeypatch.setattr(ck.ChainPlan, "__init__", init)
    monkeypatch.setattr(ck, "chain_layout", layout)
    return built, walks


def test_transformer_builds_one_plan_per_item_shape(monkeypatch):
    """37 rows in microbatches of 16 (three launches), applied twice, run
    under one plan and one walk of the chain; rows of another item shape
    get a plan of their own, once."""
    built, walks = _counting(monkeypatch)
    fbt = FusedBatchTransformer([PixelScaler(), GrayScaler(),
                                 ImageVectorizer()], microbatch=16)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random(size=(37, 8, 8, 3)) * 255.0).astype(
        np.float32))
    first = fbt.batch_fn()(x)
    again = fbt.batch_fn()(x)
    assert built == [(8, 8, 3)] and walks == [(8, 8, 3)]
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    y = torch.from_numpy((rng.random(size=(20, 4, 6, 3)) * 255.0).astype(
        np.float32))
    assert fbt.batch_fn()(y).shape == (20, 24)
    fbt.batch_fn()(y[:7])
    assert built == [(8, 8, 3), (4, 6, 3)]
    assert walks == [(8, 8, 3), (4, 6, 3)]


def test_public_wrapper_plans_per_call(monkeypatch):
    """`elementwise_chain` keeps its signature: one plan for each call."""
    built, _ = _counting(monkeypatch)
    x = torch.rand((5, 4, 4, 3)) * 255.0
    for _ in range(2):
        ck.elementwise_chain(LINEAR_PIXELS, [(), (), ()], x)
    assert built == [(4, 4, 3), (4, 4, 3)]


def _linear_pixels_scaled(rng, item):
    d = item[0] * item[1]
    mean = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, size=d).astype(np.float32))
    stages = [PixelScaler(), GrayScaler(), ImageVectorizer(),
              StandardScalerModel(mean, std)]
    statics = LINEAR_PIXELS + ((("StandardScaler",), "masked"),)
    return stages, statics, [(), (), (), (mean.numpy(), std.numpy())]


@pytest.mark.parametrize("chain", ["linear_pixels", "scaled"])
@pytest.mark.parametrize("n", [3, 11, 37])
def test_transformer_writes_its_slices_like_the_stages_and_jax(chain, n):
    """The transformer's result, each microbatch's launch written into
    its rows of one result tensor, against the stages run one by one and
    JAX's `elementwise_chain_pallas` in interpret mode at ragged counts
    (microbatches of 8; JAX blocks of 4), within 1e-6."""
    rng = np.random.default_rng(n)
    item = (6, 5, 3)
    if chain == "linear_pixels":
        stages, statics, params = ([PixelScaler(), GrayScaler(),
                                    ImageVectorizer()], LINEAR_PIXELS,
                                   [(), (), ()])
    else:
        stages, statics, params = _linear_pixels_scaled(rng, item)
    x = (rng.random(size=(n,) + item) * 255.0).astype(np.float32)
    fbt = FusedBatchTransformer(stages, microbatch=8)
    assert fbt.planned_kernel == (0, len(stages), "elementwise_chain")
    got = fbt.batch_fn()(torch.from_numpy(x)).numpy()
    stagewise = torch.from_numpy(x)
    for s in stages:
        stagewise = s.batch_fn()(stagewise)
    want_jax = np.asarray(jck.elementwise_chain_pallas(
        statics, params, jnp.asarray(x), None, block_n=4, interpret=True))
    assert got.shape == want_jax.shape == (n, 30)
    np.testing.assert_allclose(got, stagewise.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_jax, rtol=1e-6, atol=1e-6)


def test_plan_writes_into_a_slice_and_leaves_its_neighbours():
    """``out`` may be rows of a larger tensor: the plan writes those rows
    and no other, and refuses an ``out`` of another shape."""
    rng = np.random.default_rng(3)
    statics, params = _every_other_head(rng, d=16)
    x = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    mask = torch.arange(9) < 7
    plan = ck.ChainPlan(statics, params, (16,), "cpu")
    big = torch.full((15, 16), 7.0)
    got = plan(x, mask, big[3:12])
    assert got.data_ptr() == big[3:12].data_ptr()
    want = ck.elementwise_chain_reference(statics, params, x, mask)
    torch.testing.assert_close(big[3:12], want, rtol=0, atol=0)
    assert bool((big[:3] == 7.0).all()) and bool((big[12:] == 7.0).all())
    with pytest.raises(ValueError, match="out must be"):
        plan(x, mask, big[:8])
    with pytest.raises(ValueError, match="plan is for"):
        plan(x.reshape(9, 4, 4), mask)
