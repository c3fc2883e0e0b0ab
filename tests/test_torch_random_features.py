"""The random-feature nodes, the gather and its fused form: the port
against the JAX package on the CPU.

Both packages draw every random weight with numpy from the node's seed,
so signs, W and b must be identical. Features are compared within stated
tolerances:

- `PaddedFFT` and the FFT branches: pocketfft (JAX on the CPU) and
  torch's FFT round differently, within 1e-5 of the largest |feature|;
- `CosineRandomFeatures`, Gaussian: within 1e-5 (cosines lie in
  [-1, 1]);
- `CosineRandomFeatures`, Cauchy: heavy-tailed W makes |x W + b| large,
  so one rounding of the argument moves the cosine by up to that
  argument's float32 spacing. Each element is held within the forward
  error bound of the two products, 2·(d + 1)·eps32·(|x| |W| + |b|), of
  its argument.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.stats import (
    CosineRandomFeatures as JaxCosine,
    LinearRectifier as JaxRectifier,
    PaddedFFT as JaxFFT,
    RandomSignNode as JaxSign,
)
from keystone_tpu.nodes.util import VectorCombiner as JaxCombiner
from keystone_tpu.nodes.util.fusion import (
    FusedBatchTransformer as JaxFBT,
    _GatherConcatStage as JaxGatherStage,
    _stage_fuse as jax_stage_fuse,
)
from keystone_tpu.ops.chain_kernels import lowerability as jax_lowerability
from keystone_tpu.workflow import Pipeline as JaxPipeline
from keystone_tpu_torch.data.dataset import Dataset, zip_datasets
from keystone_tpu_torch.nodes.stats import (
    CosineRandomFeatures,
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from keystone_tpu_torch.nodes.util import FusedBatchTransformer, VectorCombiner
from keystone_tpu_torch.nodes.util.fusion import (
    _GatherConcatStage,
    plan_chain_kernel,
    stage_fuse,
    stage_statics,
)
from keystone_tpu_torch.ops.chain_kernels import lowerability
from keystone_tpu_torch.workflow.pipeline import Pipeline

FFT_REL = 1e-5
GAUSSIAN_ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _jax_rows(ds):
    """A JAX dataset's rows, without the padding to the mesh's shards."""
    return np.asarray(ds.array)[:ds.count]


def _close_rel(got, want, rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("dim,seed", [(8, 0), (784, 3), (100, 11)])
def test_random_sign_node_draws_the_same_signs(dim, seed):
    got = RandomSignNode(dim, seed=seed, device="cpu").signs.numpy()
    want = np.asarray(JaxSign(dim, seed=seed).signs)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {-1.0, 1.0}


@pytest.mark.parametrize("distribution", ["gaussian", "cauchy"])
def test_cosine_random_features_draws_the_same_weights(distribution):
    port = CosineRandomFeatures(40, 96, 0.0555, distribution, seed=7,
                                device="cpu")
    ref = JaxCosine(40, 96, 0.0555, distribution, seed=7)
    np.testing.assert_array_equal(port.W.numpy(), np.asarray(ref.W))
    np.testing.assert_array_equal(port.b.numpy(), np.asarray(ref.b))
    assert port.W.dtype == torch.float32 and port.b.shape == (96,)


def test_cosine_random_features_rejects_an_unknown_distribution():
    with pytest.raises(ValueError, match="unknown distribution"):
        CosineRandomFeatures(4, 8, distribution="laplace", device="cpu")


@pytest.mark.parametrize("width", [64, 100, 784])
def test_padded_fft_matches_jax(width):
    x = _rows(33, width)
    got = PaddedFFT().batch_fn()(torch.tensor(x)).numpy()
    want = np.asarray(JaxFFT().apply(jnp.asarray(x)))
    padded = 1 << int(np.ceil(np.log2(width)))
    assert got.shape == (33, padded // 2)
    _close_rel(got, want, FFT_REL)


def test_padded_fft_widens_bfloat16_to_float32():
    x = torch.tensor(_rows(5, 24)).to(torch.bfloat16)
    y = PaddedFFT().batch_fn()(x)
    assert y.dtype == torch.float32 and y.shape == (5, 16)


def test_linear_rectifier_matches_jax():
    x = _rows(20, 30)
    got = LinearRectifier(-0.2, 0.3).batch_fn()(torch.tensor(x)).numpy()
    want = np.asarray(JaxRectifier(-0.2, 0.3).apply(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_cosine_random_features_gaussian_matches_jax():
    x = _rows(300, 128)
    got = CosineRandomFeatures(128, 512, 0.0555, "gaussian", seed=3,
                               device="cpu").batch_fn()(torch.tensor(x))
    want = _jax_rows(JaxCosine(128, 512, 0.0555, "gaussian", seed=3)
                     .apply_batch(JaxDataset(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GAUSSIAN_ATOL)


def test_cosine_random_features_cauchy_matches_jax():
    x = _rows(300, 128)
    node = CosineRandomFeatures(128, 512, 0.0555, "cauchy", seed=3,
                                device="cpu")
    got = node.batch_fn()(torch.tensor(x)).numpy()
    want = _jax_rows(JaxCosine(128, 512, 0.0555, "cauchy", seed=3)
                     .apply_batch(JaxDataset(x)))
    arg_scale = np.abs(x) @ np.abs(node.W.numpy()) + np.abs(node.b.numpy())
    bound = 2 * (x.shape[1] + 1) * EPS32 * arg_scale
    assert np.all(np.abs(got - want) <= bound)


def _branch_stages(dim, n_branches):
    return [[RandomSignNode(dim, seed=i, device="cpu"), PaddedFFT(),
             LinearRectifier(0.0)] for i in range(n_branches)]


def _fused_branches(dim, n_branches):
    """Each branch as the optimizer fuses it: one FusedBatchTransformer."""
    return [FusedBatchTransformer(s) for s in _branch_stages(dim, n_branches)]


def _branches(dim, n_branches, port=True):
    if port:
        return [a >> b >> c for a, b, c in _branch_stages(dim, n_branches)]
    return [JaxSign(dim, seed=i) >> JaxFFT() >> JaxRectifier(0.0)
            for i in range(n_branches)]


def _jax_gather_features(x, dim, n_branches):
    pipe = JaxPipeline.gather(_branches(dim, n_branches, port=False)) \
        >> JaxCombiner()
    return _jax_rows(pipe(JaxDataset(x)).get())


def test_branch_chain_through_fused_batch_transformer_ragged_rows():
    """37 rows in microbatches of 16: the last one is ragged."""
    x = _rows(37, 100)
    fbt = FusedBatchTransformer(
        [RandomSignNode(100, seed=2, device="cpu"), PaddedFFT(),
         LinearRectifier(0.0)], microbatch=16)
    got = fbt.apply_batch(Dataset(x, device="cpu")).array.numpy()
    assert fbt.microbatches_run == 3
    want = _jax_rows(JaxFBT([JaxSign(100, seed=2), JaxFFT(),
                             JaxRectifier(0.0)], microbatch=16)
                     .apply_batch(JaxDataset(x)))
    _close_rel(got, want, FFT_REL)


@pytest.mark.parametrize("n,microbatch", [(300, 2048), (37, 16)])
def test_gather_combiner_and_fused_stage_match_jax(n, microbatch):
    """`Pipeline.gather >> VectorCombiner`, and the fused stage (each
    microbatch's branches writing their columns), against JAX's gather
    and combiner, branch i seeded i, in branch order."""
    dim, nb = 100, 3
    x = _rows(n, dim, seed=5)
    want = _jax_gather_features(x, dim, nb)
    data = Dataset(x, device="cpu")
    gathered = Pipeline.gather(_branches(dim, nb))(data).get()
    assert len(gathered.data) == nb and gathered.count == n
    combined = (Pipeline.gather(_branches(dim, nb)) >> VectorCombiner())(
        data).get().array.numpy()
    fused = FusedBatchTransformer(
        [_GatherConcatStage(_fused_branches(dim, nb))], microbatch=microbatch)
    got = fused.apply_batch(data).array.numpy()
    assert want.shape == (n, nb * 64)
    _close_rel(combined, want, FFT_REL)
    _close_rel(got, want, FFT_REL)
    assert fused.microbatches_run == -(-n // microbatch)
    # the gather on one datum is the list of the branch outputs
    one = Pipeline.gather(_branches(dim, nb))(torch.tensor(x[0])).get()
    assert isinstance(one, list) and len(one) == nb
    _close_rel(VectorCombiner().apply(one).numpy(), want[0], FFT_REL)


def test_branch_lowerability_matches_jax():
    """Not lowerable, with PaddedFFT the named suppression, in both."""
    port = lowerability(stage_statics(_branch_stages(784, 1)[0]))
    ref = jax_lowerability([s.fuse()[0] for s in (JaxSign(784), JaxFFT(),
                                                  JaxRectifier(0.0))])
    assert port["lowerable"] is ref["lowerable"] is False
    assert port["family"] is ref["family"] is None
    assert set(port["suppressed"]) == set(ref["suppressed"]) == {"PaddedFFT"}


def test_gather_stage_keys_match_jax_and_plan_no_chain_kernel():
    """The fused stage's key is JAX's (each branch keyed as the fused
    chain its optimizer makes of it), and no chain kernel is planned."""
    stage = _GatherConcatStage(_fused_branches(784, 4))
    ref = JaxGatherStage([JaxFBT([JaxSign(784, seed=i), JaxFFT(),
                                  JaxRectifier(0.0)]) for i in range(4)])
    key = stage_fuse(stage)[0]
    assert key == jax_stage_fuse(ref)[0]
    assert key[0] == "GatherConcat" and len(key) == 5
    assert plan_chain_kernel([key]) is None
    assert FusedBatchTransformer([stage]).planned_kernel is None
    assert jax_lowerability([key])["lowerable"] is False


def test_zip_of_misaligned_datasets_raises():
    a = Dataset(np.zeros((4, 2), np.float32), device="cpu")
    b = Dataset(np.zeros((5, 2), np.float32), device="cpu")
    with pytest.raises(ValueError, match="misaligned"):
        zip_datasets([a, b])
    with pytest.raises(ValueError, match="at least one"):
        zip_datasets([])
    z = zip_datasets([a, a])
    assert z.count == 4 and len(z.data) == 2
