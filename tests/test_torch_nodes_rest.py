"""The last nodes of the port against their JAX twins on the CPU.

- `TopKClassifier`, `FloatToDouble`, `Identity`, `Shuffler` and
  `VectorSplitter`: equal to JAX's (indices, orders and values bit for
  bit; `FloatToDouble` to float32 as JAX's without ``jax_enable_x64``);
- `utils/stats.py`: equal to JAX's helpers;
- `HogExtractor` and `DaisyExtractor`: against the JAX nodes on a
  seeded batch within 1e-6 (measured 1.5e-7), and against the goldens
  `tests/test_descriptor_goldens.py` uses on `gantrycrane.png` at that
  test's tolerances: HOG against its numpy oracle (at most 1e-3 of the
  entries off by more than 1e-3, none by 0.02), DAISY against its oracle
  within 5e-5 and against the reference suite's MATLAB sums (first
  keypoint 1e-5, all features 1e-6, relative).
"""

import os

import numpy as np
import pytest
import torch

import jax

import descriptor_reference_impls as ref
from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.dataset import HostDataset as JaxHostDataset
from keystone_tpu.nodes.images.descriptors import (
    DaisyExtractor as JaxDaisy,
    HogExtractor as JaxHog,
    daisy_blur_kernels as jax_daisy_blur_kernels,
    _round_half_up as jax_round_half_up,
)
from keystone_tpu.nodes.util import VectorSplitter as JaxVectorSplitter
from keystone_tpu.nodes.util.basic import (
    FloatToDouble as JaxFloatToDouble,
    Identity as JaxIdentity,
    Shuffler as JaxShuffler,
    TopKClassifier as JaxTopK,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.utils import stats as jax_stats
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.images.descriptors import (
    DaisyExtractor,
    HogExtractor,
    _round_half_up,
    daisy_blur_kernels,
)
from keystone_tpu_torch.nodes.util import (
    FloatToDouble,
    Identity,
    Shuffler,
    TopKClassifier,
    VectorSplitter,
)
from keystone_tpu_torch.utils import stats

RESOURCE = os.path.join(os.path.dirname(__file__), "resources",
                        "gantrycrane.png")
JAX_REL = 1e-6


def _cpu(x):
    return Dataset(x, device="cpu")


def test_top_k_classifier_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10,)).astype(np.float32)
    x[[2, 7]] = x.max() + 1.0  # a tie: index order, as JAX's stable sort
    want = np.asarray(JaxTopK(3).apply(x))
    np.testing.assert_array_equal(TopKClassifier(3).apply(x).numpy(), want)
    batch = rng.normal(size=(5, 10)).astype(np.float32)
    got = TopKClassifier(4).apply_batch(_cpu(batch)).array.numpy()
    np.testing.assert_array_equal(
        got, np.stack([np.asarray(JaxTopK(4).apply(r)) for r in batch]))


def test_float_to_double_follows_jax_dtype_rule():
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    want = np.asarray(JaxFloatToDouble().apply(x))
    assert not jax.config.jax_enable_x64 and want.dtype == np.float32
    got = FloatToDouble().apply(x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    batch = FloatToDouble().apply_batch(_cpu(x.astype(np.float16)))
    assert batch.array.dtype == torch.float32


def test_identity():
    x = np.ones((2, 2), np.float32)
    assert Identity().apply(x) is x and JaxIdentity().apply(x) is x
    ds = _cpu(x)
    assert Identity().apply_batch(ds) is ds


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_shuffler_matches_jax_bit_for_bit(seed):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(23, 4)).astype(np.float32)
    with use_mesh(make_mesh(jax.devices()[:1])):
        want = JaxShuffler(seed).apply_batch(JaxDataset(X)).numpy()
    got = Shuffler(seed).apply_batch(_cpu(X))
    assert got.count == 23
    np.testing.assert_array_equal(got.numpy(), want)
    items = [rng.normal(size=(i % 3 + 1, 2)) for i in range(11)]
    jitems = JaxShuffler(seed).apply_batch(JaxHostDataset(items)).items
    titems = Shuffler(seed).apply_batch(HostDataset(items)).items
    assert len(titems) == 11
    for a, b in zip(titems, jitems):
        np.testing.assert_array_equal(a, b)
    x = np.ones(3)
    assert Shuffler(seed).apply(x) is x


def test_vector_splitter_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(6, 10)).astype(np.float32)
    for block, nf in ((4, None), (3, 8), (10, None)):
        with use_mesh(make_mesh(jax.devices()[:1])):
            want = [b.numpy() for b in JaxVectorSplitter(block, nf)
                    .apply_batch(JaxDataset(X))]
        got = VectorSplitter(block, nf).apply_batch(_cpu(X))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.count == 6
            np.testing.assert_array_equal(g.numpy(), w)
        one = VectorSplitter(block, nf).apply(torch.from_numpy(X[0]))
        jone = JaxVectorSplitter(block, nf).apply(X[0])
        for g, w in zip(one, jone):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stats_match_jax():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4, 3))
    X[2] = 0.0
    np.testing.assert_array_equal(stats.normalize_rows(X),
                                  jax_stats.normalize_rows(X))
    np.testing.assert_array_equal(
        stats.normalize_rows(torch.from_numpy(X)), jax_stats.normalize_rows(X))
    for a, b, tol in ((X, X + 1e-9, 1e-8), (X, X + 1e-3, 1e-8),
                      (X, X[:2], 1e-8), (X, X + 1e-3, 1e-2)):
        assert stats.about_eq(a, b, tol) == jax_stats.about_eq(a, b, tol)
    rows = list(X)
    np.testing.assert_array_equal(stats.rows_to_matrix(rows),
                                  jax_stats.rows_to_matrix(rows))
    for g, w in zip(stats.matrix_to_rows(X), jax_stats.matrix_to_rows(X)):
        np.testing.assert_array_equal(g, w)


def test_daisy_taps_and_rounding_match_jax():
    for (r, q) in ((7, 3), (5, 2), (15, 4)):
        for g, w in zip(daisy_blur_kernels(r, q),
                        jax_daisy_blur_kernels(r, q)):
            np.testing.assert_array_equal(g, w)
    for v in (-2.5, -0.5, 0.5, 1.5, 2.4999, 3.5):
        assert _round_half_up(v) == jax_round_half_up(v)
    with pytest.raises(ValueError):
        DaisyExtractor(radius=9, pixel_border=8)


def _close(got, want, rel=JAX_REL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(initial=0.0))


@pytest.mark.parametrize("shape", [(48, 48, 3), (40, 56, 3), (17, 30, 3)])
def test_hog_matches_jax(shape):
    rng = np.random.default_rng(6)
    imgs = rng.random((3,) + shape).astype(np.float32)
    got = HogExtractor().apply_batch(_cpu(imgs)).array.numpy()
    for g, img in zip(got, imgs):
        _close(g, JaxHog().apply(img))
    _close(HogExtractor(cell_size=4).apply(imgs[0]).numpy(),
           JaxHog(cell_size=4).apply(imgs[0]))


@pytest.mark.parametrize("gray", [True, False])
def test_daisy_matches_jax(gray):
    rng = np.random.default_rng(8)
    imgs = rng.random((3, 48, 52, 3)).astype(np.float32)
    if gray:
        imgs = imgs[..., 0].copy()
    got = DaisyExtractor().apply_batch(_cpu(imgs)).array.numpy()
    for g, img in zip(got, imgs):
        _close(g, JaxDaisy().apply(img))
    ext, jext = (DaisyExtractor(stride=3, radius=5, rings=2, ring_points=6,
                                num_orientations=4, pixel_border=6),
                 JaxDaisy(stride=3, radius=5, rings=2, ring_points=6,
                          num_orientations=4, pixel_border=6))
    _close(ext.apply(imgs[1]).numpy(), jext.apply(imgs[1]))


def test_descriptors_over_a_host_dataset_of_mixed_shapes():
    rng = np.random.default_rng(9)
    items = [rng.random(s).astype(np.float32)
             for s in ((48, 48, 3), (40, 56, 3), (48, 48, 3))]
    out = HogExtractor().apply_batch(HostDataset(items, device="cpu")).items
    for g, img in zip(out, items):
        _close(g.numpy(), JaxHog().apply(img))


@pytest.fixture(scope="module")
def real_image():
    """tests/test_descriptor_goldens.py's crop of gantrycrane.png."""
    from PIL import Image

    img = np.asarray(Image.open(RESOURCE), dtype=np.float32) / 255.0
    return img[40:160, 60:220, :]


def test_hog_matches_numpy_reference(real_image):
    got = HogExtractor(cell_size=8).apply(real_image).numpy()
    want = ref.hog(real_image, cell_size=8)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert np.mean(diff > 1e-3) < 1e-3
    assert diff.max() < 0.02
    _close(got, JaxHog(cell_size=8).apply(real_image))


def test_daisy_matches_reference_oracle(real_image):
    gray = real_image @ np.asarray([0.299, 0.587, 0.114], np.float32)
    got = DaisyExtractor().apply(gray).numpy()
    want = ref.daisy(gray)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_daisy_matches_matlab_golden_sums():
    """DaisyExtractorSuite.scala:20-30's MATLAB sums on the full
    gantrycrane gray image (tests/test_descriptor_goldens.py)."""
    from PIL import Image

    img = np.asarray(Image.open(RESOURCE), np.float64)
    g = 0.2989 * img[:, :, 0] + 0.5870 * img[:, :, 1] + 0.1140 * img[:, :, 2]
    out = DaisyExtractor().apply(g.astype(np.float32)).numpy()
    assert out.shape == (5336, 200)
    matlab_first = 55.127217737738533
    matlab_full = 3.240635661296463e5
    assert abs(float(out[0].sum()) - matlab_first) / matlab_first < 1e-5
    assert abs(float(out.sum()) - matlab_full) / matlab_full < 1e-6
