"""The port's overlap engine on the CPU: `utils/batching.py`'s chunk
planner and streams, `prefetch_iterator`, `ExecutionConfig`, and the
workflow's chunk streams (`StreamingDatasetExpression`,
`PipelineResult.stream()`), held against the JAX package where both
compute a value.

Ports the cases of `tests/test_overlap.py:39-400` that need no telemetry
and no bench script. Every thread a test starts is joined with a timeout
and asserted dead; no test sleeps to wait for a thread: the streams join
their producer when they close, and the bounded-queue case waits on an
event its producer sets when it finds the queue full.
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu.utils import batching as jax_batching
from keystone_tpu.workflow.env import overlap_override as jax_overlap
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.utils import batching
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.env import (
    ExecutionConfig,
    config_override,
    execution_config,
    overlap_override,
    set_execution_config,
)
from keystone_tpu_torch.workflow.pipeline import Transformer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "keystone-prefetch" and t.is_alive()]


def _mixed_shape_items(rng, n_a=9, n_b=7):
    items = [rng.uniform(size=(8, 6)).astype(np.float32) for _ in range(n_a)]
    items += [rng.uniform(size=(5, 4)).astype(np.float32) for _ in range(n_b)]
    order = rng.permutation(len(items))
    return [items[i] for i in order]


@pytest.mark.parametrize("chunk,depth", [(4, 2), (2, 1), (3, 3)])
def test_overlapped_matches_serial_across_shape_buckets(chunk, depth):
    """Overlap off and on give the same rows in item order across two
    shape buckets, equal to JAX's `map_host_batched` on the same items."""
    items = _mixed_shape_items(np.random.default_rng(0))
    with overlap_override(False):
        serial = batching.map_host_batched(items, lambda x: x * 2.0 + 1.0,
                                           chunk=chunk, device=CPU)
    with overlap_override(True, prefetch_depth=depth):
        overlapped = batching.map_host_batched(
            items, lambda x: x * 2.0 + 1.0, chunk=chunk, device=CPU)
    with jax_overlap(True, prefetch_depth=depth):
        want = jax_batching.map_host_batched(
            items, lambda x: np.asarray(x) * 2.0 + 1.0, chunk=chunk)
    assert len(serial) == len(overlapped) == len(items)
    for s, o, w in zip(serial, overlapped, want):
        np.testing.assert_array_equal(o.numpy(), s.numpy())
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6)
    assert not _prefetch_threads()


def test_overlapped_two_chunk_smoke():
    """The smallest input that runs the producer thread: two chunks."""
    items = [np.full((3, 3), i, np.float32) for i in range(4)]
    with overlap_override(True, prefetch_depth=1):
        out = batching.map_host_batched(items, lambda x: x + 1, chunk=2,
                                        device=CPU)
    for i, r in enumerate(out):
        np.testing.assert_array_equal(r.numpy(), np.full((3, 3), i + 1))


def test_single_chunk_input_takes_serial_path(monkeypatch):
    """One chunk has nothing to overlap: no producer thread starts."""
    spawned = []
    orig = threading.Thread

    class Spy(orig):
        def __init__(self, *a, **kw):
            spawned.append(kw.get("name"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(threading, "Thread", Spy)
    items = [np.ones((2, 2), np.float32) for _ in range(5)]
    with overlap_override(True):
        out = batching.map_host_batched(items, lambda x: x, chunk=8,
                                        device=CPU)
    assert len(out) == 5
    assert not any(n and n.startswith("keystone-") for n in spawned)


def test_producer_exception_propagates_without_hang():
    class Cursed:
        shape = (2, 2)
        dtype = np.dtype(np.float32)

        def __array__(self, dtype=None, copy=None):
            raise ValueError("corrupt item (simulated)")

    items = [np.ones((2, 2), np.float32) for _ in range(6)] + [Cursed()]
    with overlap_override(True, prefetch_depth=1):
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="corrupt item"):
            batching.map_host_batched(items, lambda x: x, chunk=2,
                                      device=CPU)
        assert time.monotonic() - t0 < 30.0
    assert not _prefetch_threads()


def test_consumer_exception_cancels_producer():
    """A batch function's failure re-raises and the producer is joined
    before the call returns."""
    items = [np.ones((2, 2), np.float32) * i for i in range(40)]

    def fn(x):
        if float(x[0, 0, 0]) >= 4.0:
            raise RuntimeError("device rejected batch (simulated)")
        return x

    with overlap_override(True, prefetch_depth=2):
        with pytest.raises(RuntimeError, match="rejected batch"):
            batching.map_host_batched(items, fn, chunk=2, device=CPU)
    assert not _prefetch_threads()


def test_bounded_queue_caps_peak_host_memory(monkeypatch):
    """With the consumer blocked, the producer stages at most the queue's
    depth, one chunk in hand and the one being run: O(depth × chunk)
    items, within 2·depth + 2 chunks, not O(n)."""
    depth, chunk, n_chunks = 2, 4, 12
    converted = []
    release = threading.Event()
    entered = threading.Event()
    blocked = threading.Event()
    real_put = batching._bounded_put

    def watching_put(q, item, cancel):
        if q.full():
            blocked.set()  # the producer is parked on a full queue
        return real_put(q, item, cancel)

    monkeypatch.setattr(batching, "_bounded_put", watching_put)

    class Tracked:
        shape = (2, 2)
        dtype = np.dtype(np.float32)

        def __init__(self, i):
            self.i = i

        def __array__(self, dtype=None, copy=None):
            converted.append(self.i)
            return np.full((2, 2), self.i, np.float32)

    items = [Tracked(i) for i in range(chunk * n_chunks)]

    def fn(x):
        entered.set()
        release.wait(timeout=60.0)
        return x

    out = [None]

    def consume():
        with overlap_override(True, prefetch_depth=depth):
            out[0] = batching.map_host_batched(items, fn, chunk=chunk,
                                               device=CPU)

    t = threading.Thread(target=consume)
    t.start()
    try:
        assert entered.wait(timeout=30.0)
        assert blocked.wait(timeout=30.0)
        staged = len(converted)
        assert staged <= (2 * depth + 2) * chunk, staged
        assert staged < len(items)
    finally:
        release.set()
        t.join(timeout=60.0)
    assert not t.is_alive()
    for i, r in enumerate(out[0]):
        np.testing.assert_array_equal(r.numpy(), np.full((2, 2), i))


def test_prefetch_iterator_order_exception_and_early_close():
    with overlap_override(True, prefetch_depth=2):
        assert list(batching.prefetch_iterator(iter(range(20)))) == list(
            range(20))

        def broken():
            yield 1
            raise OSError("short read (simulated)")

        it = batching.prefetch_iterator(broken())
        assert next(it) == 1
        with pytest.raises(OSError, match="short read"):
            list(it)

        produced = []

        def slow_gen():
            for i in range(1000):
                produced.append(i)
                yield i

        it = batching.prefetch_iterator(slow_gen(), depth=2)
        assert next(it) == 0
        it.close()  # cancels and joins the producer
        assert not _prefetch_threads()
        assert len(produced) < 1000
    with overlap_override(False):
        assert list(batching.prefetch_iterator(iter("abc"))) == [
            "a", "b", "c"]


def test_execution_config_env_and_override(monkeypatch):
    monkeypatch.setenv("KEYSTONE_OVERLAP", "0")
    monkeypatch.setenv("KEYSTONE_PREFETCH_DEPTH", "5")
    monkeypatch.setenv("KEYSTONE_CHUNK_SIZE", "64")
    monkeypatch.setenv("KEYSTONE_MEGAFUSION", "off")
    set_execution_config(None)
    try:
        cfg = execution_config()
        assert cfg.overlap is False and cfg.prefetch_depth == 5
        assert cfg.chunk_size == 64 and cfg.megafusion is False
        with overlap_override(True, prefetch_depth=3) as inner:
            assert inner.overlap is True and inner.prefetch_depth == 3
            assert execution_config().overlap is True
        assert execution_config().overlap is False
    finally:
        set_execution_config(None)


def test_execution_config_defaults_and_chunk():
    """The port's defaults: JAX's, except the chunk of 1024 items and the
    scheduler and warm-ups, off on the card (they cost one-shot runs
    their threads' contention and gain nothing there)."""
    assert ExecutionConfig() == ExecutionConfig(
        overlap=True, prefetch_depth=2, concurrent_dispatch=False,
        dispatch_workers=4, chunk_size=1024, pad_chunks=True,
        aot_warmup=False, megafusion=True)


@pytest.mark.parametrize("n,chunk,bucket_n,want", [
    (3, 16, 3, 4), (16, 16, 43, 16), (11, 16, 43, 16), (1, 16, 1, 1),
    (9, 16, 9, 16), (5, None, 5, 5)])
def test_pad_target_matches_jax(n, chunk, bucket_n, want):
    assert batching._pad_target(n, chunk, bucket_n) == want
    assert jax_batching._pad_target(n, chunk, bucket_n) == want


def test_plan_chunks_matches_jax():
    items = _mixed_shape_items(np.random.default_rng(3), 11, 5)
    for pad in (False, True):
        assert batching._plan_chunks(items, 4, pad) == \
            jax_batching._plan_chunks(items, 4, pad)


# ---- the workflow's chunk streams ----------------------------------------


def _stream_stage(tag, log, fn):
    def apply(x):
        log.append(tag)
        return fn(x)

    return Transformer.from_function(apply, name=tag)


def test_pipeline_streams_chunks_between_host_stages(monkeypatch):
    """A chunk-capable stage after a stream-producing one starts before
    the producer's last chunk; the values equal the serial run's."""
    import keystone_tpu_torch.data.dataset as dataset_mod
    from keystone_tpu_torch.nodes.images.descriptors import LCSExtractor

    rng = np.random.default_rng(1)
    items = [rng.uniform(size=(40, 40, 3)).astype(np.float32)
             for _ in range(8)]
    ext = LCSExtractor(stride=8)
    log = []
    post = _stream_stage("post", log, lambda d: d.sum())
    pipe = ext >> post
    orig = dataset_mod.map_host_batched_stream

    def chunked(its, fn, chunk, device):
        for part, rows in orig(its, fn, 2, device):
            log.append(("chunk", tuple(part)))
            yield part, rows

    with overlap_override(True, prefetch_depth=1):
        monkeypatch.setattr(dataset_mod, "map_host_batched_stream", chunked)
        streamed = pipe(HostDataset(items, device=CPU)).get()
        monkeypatch.setattr(dataset_mod, "map_host_batched_stream", orig)
    with overlap_override(False):
        serial = pipe(HostDataset(items, device=CPU)).get()
    for s, o in zip(serial.items, streamed.items):
        np.testing.assert_allclose(np.asarray(s), np.asarray(o), rtol=1e-5)
    chunk_marks = [i for i, e in enumerate(log) if isinstance(e, tuple)]
    post_marks = [i for i, e in enumerate(log) if e == "post"]
    assert len(chunk_marks) >= 2
    assert min(post_marks) < max(chunk_marks), log


def test_pipeline_result_stream_api():
    """`PipelineResult.stream()` yields (indices, rows) chunks whose union
    is the result; `.get()` afterwards assembles the same chunks."""
    from keystone_tpu_torch.nodes.images.sift import SIFTExtractor

    rng = np.random.default_rng(2)
    items = [rng.uniform(size=(32, 32)).astype(np.float32) for _ in range(6)]
    ext = SIFTExtractor(step=8, num_scales=1)
    with overlap_override(True, prefetch_depth=1), \
            config_override(chunk_size=2):
        res = ext(HostDataset(items, device=CPU))
        seen = {}
        n_chunks = 0
        for idxs, payload in res.stream():
            assert idxs is not None
            n_chunks += 1
            for i, item in zip(idxs, payload):
                seen[i] = item
        assert n_chunks == 3
        assert sorted(seen) == list(range(len(items)))
        full = res.get()
        for i, item in seen.items():
            assert full.items[i] is not None
            np.testing.assert_array_equal(full.items[i].numpy(),
                                          item.numpy())
    with overlap_override(False):
        serial = ext(HostDataset(items, device=CPU)).get()
    for i in range(len(items)):
        np.testing.assert_array_equal(serial.items[i].numpy(),
                                      seen[i].numpy())


def test_streaming_preserves_non_host_pipelines():
    """A device `Dataset` takes the whole-value chunk: the same result
    and type."""
    double = Transformer.from_function(lambda x: x * 2.0, name="double")
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    with overlap_override(True):
        out = double(Dataset(X, device=CPU)).get()
        assert isinstance(out, Dataset)
        np.testing.assert_array_equal(out.numpy(), X * 2.0)
        chunks = list(double(Dataset(X, device=CPU)).stream())
        assert len(chunks) == 1 and chunks[0][0] is None


def test_partial_stream_drain_never_rewinds_the_producer():
    """Breaking out of `.stream()` and forcing `.get()` resumes the
    producer: each chunk runs once, and the chunk seen before the break
    is the one the final value holds."""
    items = [np.full((2, 2), i, np.float32) for i in range(8)]
    dispatched = []

    class Chunky(Transformer):
        chunkable = True

        def batch_fn(self):
            return lambda x: x + 1.0

        def apply_batch_stream(self, data):
            def fn(stacked):
                dispatched.append(stacked.shape[0])
                return stacked + 1.0

            return batching.map_host_batched_stream(data.items, fn,
                                                    chunk=2, device=CPU)

    with overlap_override(True, prefetch_depth=1):
        res = Chunky()(HostDataset(items, device=CPU))
        stream = res.stream()
        idxs0, payload0 = next(stream)
        stream.close()
        full = res.get()
    assert sum(dispatched) == len(items), dispatched
    for i, r in enumerate(full.items):
        np.testing.assert_array_equal(r.numpy(), np.full((2, 2), i + 1))
    for i, item in zip(idxs0, payload0):
        assert full.items[i].data_ptr() == item.data_ptr()
    assert not _prefetch_threads()


def test_failed_stream_stays_failed_on_reforce():
    """A producer exception mid-stream is sticky: the same expression
    re-raises on every later force and its producer never re-runs."""
    from keystone_tpu_torch.workflow.expressions import (
        StreamingDatasetExpression,
    )

    calls = {"n": 0}

    def chunks():
        calls["n"] += 1
        yield [0, 1], ["a", "b"]
        raise ValueError("producer died (simulated)")

    expr = StreamingDatasetExpression(chunks)
    with pytest.raises(ValueError, match="producer died"):
        for _ in expr.iter_chunks():
            pass
    with pytest.raises(ValueError, match="producer died"):
        expr.get
    with pytest.raises(ValueError, match="producer died"):
        list(expr.iter_chunks())
    assert calls["n"] == 1


def test_host_dataset_map_batches_equals_jax_across_chunks():
    """`HostDataset.map_batches` through the stream of chunks of 4: the
    buckets are the shape groups, each chunk written into its group's
    tensor, and the items equal JAX's `map_host_batched` on the same
    items and function."""
    items = _mixed_shape_items(np.random.default_rng(4), 13, 6)
    with config_override(chunk_size=4):
        out = HostDataset(items, device=CPU).map_batches(
            lambda x: torch.tanh(x) + x.sum(dim=-1, keepdim=True))
    want = jax_batching.map_host_batched(
        items, lambda x: np.tanh(np.asarray(x))
        + np.asarray(x).sum(-1, keepdims=True), chunk=4)
    assert [len(idx) for idx, _ in out.buckets()] == [13, 6]
    for got, w in zip(out.items, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_map_chunks_applies_a_stage_lazily_per_chunk():
    """`map_chunks` maps each chunk's payload (the whole-value chunk by
    its own function) without forcing the source until drained, and its
    assembled value holds the chunks as buckets."""
    from keystone_tpu_torch.workflow.expressions import (
        StreamingDatasetExpression,
    )

    pulled = []

    def chunks():
        for idxs in ([0, 1], [2, 3, 4]):
            pulled.append(idxs)
            yield idxs, torch.tensor([[float(i)] for i in idxs])

    mapped = StreamingDatasetExpression(chunks).map_chunks(
        lambda rows: rows * 10.0, lambda whole: whole)
    assert pulled == []
    value = mapped.get
    assert pulled == [[0, 1], [2, 3, 4]]
    assert [idx for idx, _ in value.buckets()] == [[0, 1], [2, 3, 4]]
    np.testing.assert_array_equal(
        torch.cat([value.items[i] for i in range(5)]).numpy(),
        np.arange(5, dtype=np.float32) * 10.0)
    whole = StreamingDatasetExpression(lambda: iter([(None, "all")]))
    assert whole.map_chunks(str.upper, str.upper).get == "ALL"
