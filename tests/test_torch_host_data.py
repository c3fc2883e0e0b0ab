"""Host datasets, their batched stages and the host zip: the port against
the JAX package on the CPU.

A `HostDataset` holds items of any shapes. The port's batched stages
group them by shape, stack each group once and keep their results as
those groups; every test here holds the items that come out, in item
order, to the JAX package's (`keystone_tpu/data/dataset.py:278-341`,
`:599-600`; `utils/batching.py:669-695`): exactly where a stage stacks,
gathers or scales, and to 2.5e-7 relative where it takes a square root.
"""

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import (
    HostDataset as JaxHostDataset,
    zip_datasets as jax_zip,
)
from keystone_tpu.nodes.images.core import (
    GrayScaler as JaxGray,
    PixelScaler as JaxPixel,
)
from keystone_tpu.nodes.images.extractors import (
    ImageExtractor as JaxImageExtractor,
    LabelExtractor as JaxLabelExtractor,
    MultiLabelExtractor as JaxMultiLabelExtractor,
    MultiLabeledImageExtractor as JaxMultiImageExtractor,
)
from keystone_tpu.nodes.stats import (
    ColumnSampler as JaxColumnSampler,
    NormalizeRows as JaxNormalizeRows,
    Sampler as JaxSampler,
    SignedHellingerMapper as JaxHellinger,
)
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromIntArray as JaxIndicatorsArray,
    MatrixVectorizer as JaxMatrixVectorizer,
)
from keystone_tpu.utils.images import (
    LabeledImage as JaxLabeledImage,
    MultiLabeledImage as JaxMultiLabeledImage,
)
from keystone_tpu_torch.data.dataset import (
    Dataset,
    HostDataset,
    ZippedHostDataset,
    zip_datasets,
)
from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.nodes.images.extractors import (
    ImageExtractor,
    LabelExtractor,
    MultiLabeledImageExtractor,
    MultiLabelExtractor,
)
from keystone_tpu_torch.nodes.stats import (
    ColumnSampler,
    NormalizeRows,
    Sampler,
    SignedHellingerMapper,
)
from keystone_tpu_torch.nodes.util import (
    ClassLabelIndicatorsFromIntArray,
    MatrixVectorizer,
)
from keystone_tpu_torch.utils.batching import map_host_batched
from keystone_tpu_torch.workflow.env import config_override
from keystone_tpu_torch.utils.images import LabeledImage, MultiLabeledImage

CPU = "cpu"


def _items_of_three_shapes(seed=0):
    """Eleven items of three shapes, interleaved."""
    rng = np.random.default_rng(seed)
    shapes = [(5, 4), (3, 4), (5, 4), (7, 2), (3, 4), (5, 4), (7, 2),
              (7, 2), (3, 4), (5, 4), (7, 2)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _host(items):
    return [np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in items]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(_host(got), _host(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_map_host_batched_keeps_item_order_over_three_shapes():
    items = _items_of_three_shapes()
    calls = []

    def batch_fn(x):
        calls.append(tuple(x.shape))
        return torch.tanh(x) * 2.0 + x.sum(dim=-1, keepdim=True)

    got = map_host_batched(items, batch_fn, chunk=2, device=CPU)
    want = [batch_fn(torch.from_numpy(x)[None])[0] for x in items]
    _assert_items_equal(got, want)
    # one call a chunk of two: buckets of 4, 3 and 4 items, the 3-item
    # bucket's tail padded to the chunk (ExecutionConfig.pad_chunks)
    assert [c[0] for c in calls[:6]] == [2, 2, 2, 2, 2, 2]
    calls.clear()
    with config_override(pad_chunks=False):
        got = map_host_batched(items, batch_fn, chunk=2, device=CPU)
    _assert_items_equal(got, want)
    assert [c[0] for c in calls] == [2, 2, 2, 1, 2, 2]


def test_map_batches_keeps_buckets_and_stacks_without_copies():
    items = _items_of_three_shapes(1)
    ds = HostDataset(items, device=CPU)
    out = ds.map_batches(lambda x: x * 3.0)
    assert [idx for idx, _ in out.buckets()] == [
        [0, 2, 5, 9], [1, 4, 8], [3, 6, 7, 10]]
    _assert_items_equal(out.items, [x * 3.0 for x in items])
    same = HostDataset([x for x in items if x.shape == (5, 4)], device=CPU)
    stacked = same.map_batches(lambda x: x + 1.0)
    t = stacked.buckets()[0][1]
    assert stacked.stack().array.data_ptr() == t.data_ptr()


def test_stack_matches_jax_and_orders_mixed_buckets():
    rng = np.random.default_rng(2)
    items = [rng.normal(size=(6,)).astype(np.float32) for _ in range(9)]
    want = np.asarray(JaxHostDataset(items).stack(dtype=np.float32).array)
    got = HostDataset(items, device=CPU).stack(dtype=np.float32)
    assert isinstance(got, Dataset) and got.count == 9
    np.testing.assert_array_equal(got.numpy(), want[:9])
    # items of one shape but two dtypes: two buckets, stacked in order
    mixed = [x.astype(np.float64) if i % 3 == 0 else x
             for i, x in enumerate(items)]
    got = HostDataset(mixed, device=CPU).stack(dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want[:9])
    with pytest.raises(ValueError, match="shapes"):
        HostDataset(_items_of_three_shapes(), device=CPU).stack()


def test_map_numpy_take_len_iter():
    items = _items_of_three_shapes(3)
    ds = HostDataset(items, device=CPU)
    jds = JaxHostDataset(items)
    assert len(ds) == len(jds) == ds.count == 11
    _assert_items_equal(ds.map(lambda x: x[:1]).items,
                        jds.map(lambda x: x[:1]).items)
    _assert_items_equal(ds.take(4), jds.take(4))
    _assert_items_equal(list(ds), list(jds))
    bucketed = ds.map_batches(lambda x: x - 1.0)
    _assert_items_equal(bucketed.numpy(), [x - 1.0 for x in items])
    assert all(isinstance(x, np.ndarray) for x in bucketed.numpy())


def test_zip_of_host_datasets_gives_lists_as_jax():
    a = _items_of_three_shapes(4)
    b = [np.float32(i) * np.ones(3, np.float32) for i in range(11)]
    want = jax_zip([JaxHostDataset(a), JaxHostDataset(b)])
    got = zip_datasets([HostDataset(a, device=CPU),
                        HostDataset(b, device=CPU).map_batches(
                            lambda x: x)])
    assert isinstance(got, ZippedHostDataset) and len(got) == len(want)
    for g, w in zip(got.items, want.items):
        assert isinstance(g, list) and len(g) == 2
        _assert_items_equal(g, w)
    with pytest.raises(TypeError):
        zip_datasets([HostDataset(a, device=CPU),
                      Dataset(np.zeros((11, 2), np.float32), device=CPU)])


def test_execute_runs_the_batch_path_over_a_host_dataset():
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 255, size=s).astype(np.float32)
            for s in [(8, 6, 3), (5, 7, 3), (8, 6, 3), (5, 7, 3), (8, 6, 3)]]
    labeled = [LabeledImage(x, i % 3) for i, x in enumerate(imgs)]
    jax_labeled = [JaxLabeledImage(x, i % 3) for i, x in enumerate(imgs)]
    ds = HostDataset(labeled, device=CPU)
    out = (ImageExtractor().to_pipeline() >> PixelScaler() >> GrayScaler())(
        ds).get()
    assert isinstance(out, HostDataset)
    # one bucket a shape: each stage ran twice, not once an image
    assert len(out.buckets()) == 2
    want = JaxGray().apply_batch(JaxPixel().apply_batch(
        JaxImageExtractor().apply_batch(JaxHostDataset(jax_labeled))))
    _assert_items_equal(out.items, want.items)
    labels = (LabelExtractor().to_pipeline())(ds).get()
    assert labels.items == JaxLabelExtractor().apply_batch(
        JaxHostDataset(jax_labeled)).items
    # and a single datum still goes through `apply`
    one = (PixelScaler() >> GrayScaler())(imgs[0]).get()
    np.testing.assert_array_equal(np.asarray(one), np.asarray(want.items[0]))


def test_multi_label_extractors_match_jax():
    rng = np.random.default_rng(6)
    imgs = [rng.uniform(0, 255, size=(4, 4, 3)).astype(np.float32)
            for _ in range(4)]
    labels = [[0, 2], [1], [3, 0], [2]]
    port = HostDataset([MultiLabeledImage(x, l) for x, l in
                        zip(imgs, labels)], device=CPU)
    jax = JaxHostDataset([JaxMultiLabeledImage(x, l) for x, l in
                          zip(imgs, labels)])
    _assert_items_equal(MultiLabeledImageExtractor().apply_batch(port).items,
                        JaxMultiImageExtractor().apply_batch(jax).items)
    assert MultiLabelExtractor().apply_batch(port).items == \
        JaxMultiLabelExtractor().apply_batch(jax).items


@pytest.mark.parametrize("node,jax_node", [
    (MatrixVectorizer(), JaxMatrixVectorizer()),
    (SignedHellingerMapper(), JaxHellinger()),
    (NormalizeRows(), JaxNormalizeRows()),
    (ColumnSampler(4, seed=3), JaxColumnSampler(4, seed=3)),
], ids=["matrix_vectorizer", "signed_hellinger", "normalize_rows",
        "column_sampler"])
def test_per_item_stages_over_buckets_match_jax(node, jax_node):
    """Each stage over a bucketed dataset of three item shapes against
    the JAX package's per-item host path: the gathers exactly; the two
    that take a square root to 2.5e-7 relative, as XLA's float32 sqrt on
    the CPU is not always correctly rounded (1 ulp) and NormalizeRows
    sums in another order."""
    items = _items_of_three_shapes(7)
    got = node.apply_batch(HostDataset(items, device=CPU))
    want = jax_node.apply_batch(JaxHostDataset(items))
    if isinstance(node, (NormalizeRows, SignedHellingerMapper)):
        for g, w in zip(_host(got.items), _host(want.items)):
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=0)
    else:
        _assert_items_equal(got.items, want.items)
    if hasattr(jax_node, "fuse"):
        assert node.fuse() == jax_node.fuse()[:2]


def test_sampler_picks_jax_rows_on_host_and_device():
    items = _items_of_three_shapes(8)
    got = Sampler(5, seed=2).apply_batch(HostDataset(items, device=CPU))
    want = JaxSampler(5, seed=2).apply_batch(JaxHostDataset(items))
    _assert_items_equal(got.items, want.items)
    rows = np.arange(40, dtype=np.float32).reshape(20, 2)
    got = Sampler(7, seed=1).apply_batch(Dataset(rows, device=CPU))
    idx = np.random.default_rng(1).choice(20, 7, replace=False)
    np.testing.assert_array_equal(got.numpy(), rows[np.sort(idx)])


def test_multi_label_indicators_match_jax():
    Y = np.array([[0, 2], [1, -1], [3, 3], [-1, -1], [2, 0]], np.int32)
    from keystone_tpu.data.dataset import Dataset as JaxDataset

    want = JaxIndicatorsArray(4).apply_batch(JaxDataset(Y))
    got = ClassLabelIndicatorsFromIntArray(4)(Dataset(Y, device=CPU)).get()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want.array)[:want.count])
    np.testing.assert_array_equal(
        ClassLabelIndicatorsFromIntArray(4).apply(Y[1]).numpy(),
        np.asarray(JaxIndicatorsArray(4).apply(Y[1])))
