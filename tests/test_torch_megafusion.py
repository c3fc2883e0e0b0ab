"""Megafusion on the CPU: `MegafusionRule`'s plans against the JAX
package's, `MegafusedBatchTransformer`'s padded chunk loop against JAX's
megafused apply, and the cases of `tests/test_megafusion.py:77-347`
that need no telemetry, specs or TPU programs.

Plans: after each of the batches ``state``, ``cse``, ``fuse`` and
``node-opt``, the port's and JAX's `DefaultOptimizer(megafuse=True,
sharding_planner=False, precision_planner=False,
unified_planner=False)` plans are equal node by node in
`linearize` order: operator class, label, stage list (fit slots as
``fit:i``) and whether the node keeps a saveable prefix. The JAX side
runs on a one-device mesh (ROADMAP, ground rules). On the CPU a
megafused chain runs its padded loop eagerly; the graph it replays on
the card is held in `tests/test_torch_cuda_kernels.py`.
"""

import pickle

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import LinearMapEstimator as JaxLinearMap
from keystone_tpu.nodes.stats import (
    NormalizeRows as JaxNormalizeRows,
    StandardScaler as JaxStandardScaler,
)
from keystone_tpu.nodes.util import ClassLabelIndicatorsFromInt as JaxIndic
from keystone_tpu.nodes.util.fusion import (
    MegafusedBatchTransformer as JaxMegafused,
)
from keystone_tpu.workflow import DefaultOptimizer as JaxDefaultOptimizer
from keystone_tpu.workflow import PipelineEnv as JaxPipelineEnv
from keystone_tpu.workflow import Transformer as JaxTransformer
from keystone_tpu.workflow.analysis import linearize as jax_linearize
from keystone_tpu.workflow.graph import Graph as JaxGraph
from keystone_tpu.workflow.graph import NodeId as JaxNodeId
from keystone_tpu.workflow.operators import DatasetOperator as JaxDatasetOp
from keystone_tpu_torch.telemetry import metrics_delta
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.learning import LinearMapEstimator
from keystone_tpu_torch.nodes.stats.normalization import (
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.nodes.stats.scalers import (
    StandardScaler,
    StandardScalerModel,
)
from keystone_tpu_torch.nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    MegafusedBatchTransformer,
)
from keystone_tpu_torch.utils import batching
from keystone_tpu_torch.workflow import (
    DatasetOperator,
    DefaultOptimizer,
    Graph,
    NodeId,
    PipelineEnv,
    Transformer,
)
from keystone_tpu_torch.workflow.analysis import linearize
from keystone_tpu_torch.workflow.env import (
    config_override,
    dispatch_override,
    overlap_override,
)
from keystone_tpu_torch.workflow.fusion_rule import (
    MegafusionRule,
    NodeFusionRule,
    megafusion_blockers,
)
from test_torch_optimizer import (  # noqa: F401  (one_device_mesh: fixture)
    PARITY_BATCHES,
    _linear_pixels,
    _mnist_random_fft,
    _random_patch_cifar,
    _run,
    one_device_mesh,
)

CPU = torch.device("cpu")
RAGGED_N, CHUNK = 43, 16


@pytest.fixture(autouse=True)
def _clean_env():
    PipelineEnv.reset()
    JaxPipelineEnv.reset()
    yield
    PipelineEnv.reset()
    JaxPipelineEnv.reset()


# ---- plans ------------------------------------------------------------------


def _detail_trace(optimizer, graph, linearize_fn, node_type):
    """[(batch, [(class, label, stage list, keeps a prefix)])] after each
    of PARITY_BATCHES, nodes in `linearize` order."""
    plan, out = (graph, {}), []
    for batch in optimizer.batches:
        plan = _run(batch, plan, optimizer)
        if batch.name not in PARITY_BATCHES:
            continue
        g, prefixes = plan
        rows = []
        for v in linearize_fn(g):
            if not isinstance(v, node_type):
                continue
            op = g.get_operator(v)
            specs = getattr(op, "stage_specs", None)
            stages = None if specs is None else [
                repr(s) if type(s).__name__ == "_FitSlot" else s.label
                for s in specs]
            rows.append((type(op).__name__, op.label, stages,
                         v in prefixes))
        out.append((batch.name, rows))
    return out


def _jax_fusable(name):
    class _F(JaxTransformer):
        fusable = True

        @property
        def label(self):
            return name

        def apply(self, x):
            return x + 1.0

    return _F()


def _port_fusable(name):
    class _F(Transformer):
        fusable = True

        @property
        def label(self):
            return name

        def batch_fn(self):
            return lambda x: x + 1.0

    return _F()


def _fan_out():
    """A >> B, then B's output read by C and by D: the fan-out ends the
    chain in both rules."""
    graphs = []
    for graph_cls, dataset_op, fusable, data in (
            (JaxGraph, JaxDatasetOp, _jax_fusable,
             JaxDataset.from_numpy(np.ones((4, 2), np.float32))),
            (Graph, DatasetOperator, _port_fusable,
             Dataset(np.ones((4, 2), np.float32), device=CPU))):
        g = graph_cls()
        g, d = g.add_node(dataset_op(data), [])
        g, a = g.add_node(fusable("A"), [d])
        g, b = g.add_node(fusable("B"), [a])
        g, c = g.add_node(fusable("C"), [b])
        g, e = g.add_node(fusable("D"), [b])
        g, _ = g.add_sink(c)
        g, _ = g.add_sink(e)
        graphs.append(g)
    return tuple(graphs)


@pytest.mark.parametrize("build", [_random_patch_cifar, _linear_pixels,
                                   _mnist_random_fft, _fan_out],
                         ids=["random_patch_cifar", "linear_pixels",
                              "mnist_random_fft", "fan_out"])
def test_megafused_plan_equals_jax_batch_by_batch(build, one_device_mesh):
    jax_graph, port_graph = build()
    jax_opt = JaxDefaultOptimizer(megafuse=True, sharding_planner=False,
                                  precision_planner=False,
                                  unified_planner=False)
    want = _detail_trace(jax_opt, jax_graph, jax_linearize, JaxNodeId)
    got = _detail_trace(DefaultOptimizer(sharding_planner=False,
                                         precision_planner=False,
                                         unified_planner=False),
                        port_graph, linearize, NodeId)
    assert [b for b, _ in got] == list(PARITY_BATCHES)
    assert got == want


@pytest.mark.parametrize("build,megafused", [
    (_random_patch_cifar, 1), (_linear_pixels, 1), (_mnist_random_fft, 1),
    (_fan_out, 0)])
def test_megafused_plan_counts(build, megafused):
    """The default plan holds one Megafused node where the apply path is
    fan-out free, none across a fan-out; megafusion off holds none."""
    _, graph = build()
    labels = [op.label for op in DefaultOptimizer().execute(graph)[0]
              .operators.values()]
    assert sum(l.startswith("Megafused[") for l in labels) == megafused
    with config_override(megafusion=False):
        labels = [op.label for op in DefaultOptimizer().execute(graph)[0]
                  .operators.values()]
    assert not any(l.startswith("Megafused[") for l in labels)


# ---- outputs ----------------------------------------------------------------


def _jax_apply_pipeline(X, y, k):
    train = JaxDataset.from_numpy(X)
    labels = JaxIndic(k)(JaxDataset.from_numpy(y)).get()
    return (JaxNormalizeRows().to_pipeline()
            .and_then(JaxStandardScaler(), train)
            .and_then(JaxLinearMap(0.1), train, labels))


def _port_apply_pipeline(X, y, k, argmax=False):
    train = Dataset(X, device=CPU)
    labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=CPU)).get()
    pipe = (NormalizeRows().to_pipeline()
            .and_then(StandardScaler(), train)
            .and_then(LinearMapEstimator(0.1), train, labels))
    return (pipe >> MaxClassifier()) if argmax else pipe


def _data(n_train=24, n_test=RAGGED_N, d=6, k=3, seed=3):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(size=(n_train, d))).astype(np.float32) + 1.0
    y = rng.integers(0, k, n_train).astype(np.int32)
    Xt = np.abs(rng.normal(size=(n_test, d))).astype(np.float32) + 1.0
    return X, y, Xt, k


@pytest.mark.parametrize("n_test", [24, RAGGED_N, 2100])
def test_megafused_apply_equals_jax(n_test, one_device_mesh):
    """JAX's megafused apply against the port's megafused chain built
    from JAX's fitted scaler and linear map (carried by `convert`), on
    the same rows: scores within 1e-5 of max|score|. 2,100 rows pad to
    two trips of 2,048."""
    X, y, Xt, k = _data(n_test=n_test)
    jax_pipe = _jax_apply_pipeline(X, y, k)
    res = jax_pipe(JaxDataset.from_numpy(Xt))
    want = np.asarray(res.get().numpy())[:n_test]
    jax_fitted = jax_pipe.fit()
    (jax_mega,) = [op for op in jax_fitted.graph.operators.values()
                   if isinstance(op, JaxMegafused)]
    scaler, mapper = jax_mega.stages[1], jax_mega.stages[2]
    assert mapper.feature_scaler is None
    mega = MegafusedBatchTransformer([
        NormalizeRows(),
        StandardScalerModel(convert.to_tensor(scaler.mean, "cpu"),
                            convert.to_tensor(scaler.std, "cpu")),
        convert.linear_mapper(mapper.W, mapper.b, "cpu")])
    with metrics_delta() as d:
        got = mega.batch_fn()(torch.tensor(Xt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert d.counter("megafusion.scan_trips") == \
        -(-mega.rung(n_test) // mega.microbatch)


@pytest.mark.parametrize("n_test", [24, RAGGED_N])
def test_apply_plan_collapses_to_one_program(n_test):
    """The apply run's plan holds one Megafused node that runs its chunk
    loop once (one trip at these sizes), equal to the serial unfused
    path, also at a ragged count."""
    X, y, Xt, k = _data(n_test=n_test)
    with overlap_override(False), dispatch_override(False), \
            config_override(megafusion=False):
        PipelineEnv.get().set_optimizer(DefaultOptimizer(megafuse=False))
        pipe = _port_apply_pipeline(X, y, k, argmax=True)
        pipe(Dataset(X, device=CPU)).get()
        reference = pipe(Dataset(Xt, device=CPU)).get().numpy()
    PipelineEnv.reset()
    pipe = _port_apply_pipeline(X, y, k, argmax=True)
    pipe(Dataset(X, device=CPU)).get()  # the fit run (fan-out)
    res = pipe(Dataset(Xt, device=CPU))
    out = res.get().numpy()
    labels = [op.label
              for op in res.executor.optimized_graph.operators.values()]
    assert sum(l.startswith("Megafused[") for l in labels) == 1, labels
    np.testing.assert_array_equal(out, reference)


def test_fit_bakes_megafused_transformer(tmp_path):
    """`Pipeline.fit()` bakes the `MegafusedBatchTransformer`; the fitted
    pipeline applies as the lazy one, and survives save and load, which
    drops its graphs and lock and rebuilds them empty."""
    from keystone_tpu_torch.workflow import FittedPipeline

    X, y, _, k = _data()
    pipe = _port_apply_pipeline(X, y, k, argmax=True)
    lazy = pipe(Dataset(X, device=CPU)).get().numpy()
    fitted = pipe.fit()
    baked = [op for op in fitted.graph.operators.values()
             if isinstance(op, MegafusedBatchTransformer)]
    assert len(baked) == 1
    np.testing.assert_array_equal(fitted(Dataset(X, device=CPU)).numpy(),
                                  lazy)
    baked[0]._graphs[("shape",)] = object()  # stands in for a capture
    state = baked[0].__getstate__()
    assert "_graphs" not in state and "graph_lock" not in state
    assert "_eager_calls" not in state
    path = str(tmp_path / "mega.pkl")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    (mega,) = [op for op in loaded.graph.operators.values()
               if isinstance(op, MegafusedBatchTransformer)]
    assert mega._graphs == {} and mega._eager_calls == {}
    np.testing.assert_array_equal(loaded(Dataset(X, device=CPU)).numpy(),
                                  lazy)


@pytest.mark.parametrize("n,microbatch,rung", [
    (1, 2048, 1), (3, 2048, 4), (43, 2048, 64), (2048, 2048, 2048),
    (2049, 2048, 4096), (10_000, 2048, 10_240), (10_000, 4096, 12_288),
    (700, 512, 1024)])
def test_rung(n, microbatch, rung):
    assert MegafusedBatchTransformer([], microbatch=microbatch).rung(n) \
        == rung


def test_megafused_cpu_loop_counts_trips():
    """On the CPU the padded loop runs eagerly: 1,100 rows at microbatch
    512 run three trips, the nested chain three microbatches, and the
    real rows equal the unpadded chain's."""
    inner = FusedBatchTransformer([NormalizeRows(), SignedHellingerMapper()],
                                  microbatch=512)
    mega = MegafusedBatchTransformer([inner], microbatch=512)
    x = torch.rand((1100, 7)) + 0.1
    with metrics_delta() as d:
        got = mega.batch_fn()(x)
    assert d.counter("megafusion.scan_trips") == 3
    assert inner.microbatches_run == 3
    want = FusedBatchTransformer([NormalizeRows(), SignedHellingerMapper()],
                                 microbatch=512).batch_fn()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert d.counter("megafusion.graph_captures") == \
        d.counter("megafusion.graph_replays") == 0


# ---- the host batcher: a bucket's chunks as one run --------------------------


def _host_items(n=RAGGED_N, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(dim,)).astype(np.float32)) + 1.0
            for _ in range(n)]


def _doubler():
    return FusedBatchTransformer([_port_fusable("x+1")])


def test_host_bucket_scans_as_one_program():
    """43 same-shape items at chunk 16: one run of the bucket's three
    padded chunks (three trips) against three per-chunk calls with
    megafusion off; indices cover range(43); equal values."""
    items = _host_items()
    fbt = _doubler()
    with config_override(megafusion=True, pad_chunks=True), \
            metrics_delta() as d:
        seen = {}
        for idxs, payload in batching.map_host_batched_stream(
                items, fbt.batch_fn(), chunk=CHUNK, device=CPU):
            assert len(idxs) == len(payload) <= CHUNK
            for i, row in zip(idxs, payload):
                assert i not in seen
                seen[i] = row
    assert d.counter("megafusion.scan_trips") == 3
    assert fbt.microbatches_run == 3
    assert sorted(seen) == list(range(RAGGED_N))
    plain = _doubler()
    with config_override(megafusion=False, pad_chunks=True), \
            metrics_delta() as d:
        reference = batching.map_host_batched(items, plain.batch_fn(),
                                              chunk=CHUNK, device=CPU)
    assert d.counter("megafusion.scan_trips") == 0
    assert plain.microbatches_run == 3
    for i in range(RAGGED_N):
        np.testing.assert_array_equal(seen[i].numpy(),
                                      reference[i].numpy())
        np.testing.assert_allclose(seen[i].numpy(), items[i] + 1.0)


def test_host_code_batch_fn_falls_back_per_chunk():
    """A host callable is never run as one: the per-chunk stream runs it,
    each chunk padded to the chunk size."""
    items = _host_items()
    shapes = []

    def hostfn(xb):
        shapes.append(xb.shape[0])
        return xb * 2.0

    with config_override(megafusion=True, pad_chunks=True):
        out = batching.map_host_batched(items, hostfn, chunk=CHUNK,
                                        device=CPU)
    assert shapes == [CHUNK, CHUNK, CHUNK], shapes
    for i in range(RAGGED_N):
        np.testing.assert_allclose(out[i].numpy(), items[i] * 2.0)


@pytest.mark.parametrize("pad,cap,runs,trips", [
    (True, 4, 3, 10), (True, 64, 1, 10), (False, 64, 0, 0)])
def test_host_megafusion_residency_cap_and_padding(monkeypatch, pad, cap,
                                                   runs, trips):
    """A run never stacks more than `_MEGAFUSED_MAX_TRIPS` chunks: 40
    items at chunk 4 (10 chunks) run as 4 + 4 + 2 at a cap of 4, as one
    run at 64; with padding off the ragged-free chunks still run alone
    per chunk, as the JAX package's do (no stackable group)."""
    monkeypatch.setattr(batching, "_MEGAFUSED_MAX_TRIPS", cap)
    items = _host_items(n=38 if not pad else 40)
    fbt = _doubler()
    calls = []
    real = fbt.run_rung

    def counting(stack, rows, trip):
        calls.append(rows // trip)
        return real(stack, rows, trip)

    monkeypatch.setattr(fbt, "run_rung", counting)
    with config_override(megafusion=True, pad_chunks=pad):
        out = batching.map_host_batched(items, fbt.batch_fn(), chunk=4,
                                        device=CPU)
    assert len(calls) == runs and sum(calls) == trips
    for i, x in enumerate(items):
        np.testing.assert_allclose(out[i].numpy(), x + 1.0)


# ---- plans that do not megafuse -------------------------------------------


class _ChunkProducer(Transformer):
    """A bucketed host stage that streams its chunks (SIFT's pattern)."""

    chunkable = True

    def batch_fn(self):
        return lambda x: x * 2.0

    def apply_batch_stream(self, data):
        return batching.map_host_batched_stream(
            data.items, lambda xb: xb * 2.0, chunk=4, device=CPU)


def test_streaming_plan_keeps_chunk_flow():
    """A plan headed by a stream-producing stage does not megafuse: its
    chunks keep flowing through the fused chain after it."""
    items = _host_items(n=12)
    pipe = (_ChunkProducer().to_pipeline()
            >> NormalizeRows() >> SignedHellingerMapper())
    with overlap_override(True, prefetch_depth=1):
        res = pipe(HostDataset(items, device=CPU))
        labels = [op.label
                  for op in res.executor.optimized_graph.operators.values()]
        assert not any(l.startswith("Megafused[") for l in labels), labels
        n_chunks, seen = 0, {}
        for idxs, payload in res.stream():
            assert idxs is not None, "stream materialized"
            n_chunks += 1
            for i, item in zip(idxs, payload):
                seen[i] = item
    assert n_chunks >= 2
    assert sorted(seen) == list(range(12))


def test_fanout_terminates_megafusion():
    _, g = _fan_out()
    plan = NodeFusionRule().apply((g, {}))
    plan = MegafusionRule().apply(plan)
    labels = sorted(op.label for op in plan[0].operators.values()
                    if not op.label.startswith("Dataset"))
    assert labels == ["C", "D", "Fused[A >> B]"], labels


def test_absorbed_cacher_prefix_not_poisoned():
    """A Cacher at the head of a merged chain is absorbed with its
    prefix: a second pipeline sharing that head reads its own value, not
    the whole chain's."""
    rng = np.random.default_rng(21)
    X = np.abs(rng.normal(size=(16, 5))).astype(np.float32) + 1.0
    ds = Dataset(X, device=CPU)
    shared = Cacher("c")
    pipe1 = (shared.to_pipeline() >> NormalizeRows()
             >> Cacher("mid") >> SignedHellingerMapper())
    pipe2 = shared.to_pipeline() >> NormalizeRows()
    pipe1(ds).get()
    out2 = pipe2(ds).get().numpy()
    expected = X / np.linalg.norm(X, axis=1, keepdims=True)
    np.testing.assert_allclose(out2, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("example", ["mnist_random_fft",
                                     "random_patch_cifar"])
def test_kill_switch_reverts_plan_with_equal_predictions(example):
    """Megafusion off gives the plan without it, and the same
    predictions on the apply path."""
    from test_torch_optimizer import _cifar_pair

    if example == "mnist_random_fft":
        from keystone_tpu_torch.loaders.csv_loader import LabeledData
        from keystone_tpu_torch.pipelines import mnist_random_fft as mnist

        rng = np.random.default_rng(0)
        x = rng.uniform(size=(64, 32)).astype(np.float32)
        y = rng.integers(0, 10, size=64).astype(np.int32)
        train = LabeledData.from_arrays(y, x, "cpu")
        test = Dataset(rng.uniform(size=(20, 32)).astype(np.float32),
                       device=CPU)
        build = lambda: mnist.build(  # noqa: E731
            train, mnist.MnistRandomFFTConfig(num_ffts=3, block_size=64))
    else:
        from keystone_tpu_torch.pipelines import random_patch_cifar as rpc

        (_, _), (train, test_data) = _cifar_pair()
        test = test_data.data
        cfg = rpc.RandomPatchCifarConfig(num_filters=8, microbatch=16)
        build = lambda: rpc.build_pipeline(train, cfg)  # noqa: E731
    preds = {}
    for mega in (True, False):
        PipelineEnv.reset()
        with config_override(megafusion=mega):
            res = build()(test)
            labels = [op.label for op in
                      res.executor.optimized_graph.operators.values()]
            preds[mega] = res.get().numpy()
        assert any(l.startswith("Megafused[") for l in labels) == mega
    np.testing.assert_array_equal(preds[True], preds[False])


def test_megafusion_blockers_name_the_host_stage():
    """A host-code stage between two fusable stages blocks the chain,
    and the blockers say so; a fusable plan has none."""
    data = Dataset(np.ones((4, 3), np.float32), device=CPU)
    host = Transformer.from_function(lambda x: x, name="host")
    g = Graph()
    g, d = g.add_node(DatasetOperator(data), [])
    g, a = g.add_node(_port_fusable("A"), [d])
    g, h = g.add_node(host, [a])
    g, b = g.add_node(_port_fusable("B"), [h])
    g, _ = g.add_sink(b)
    blockers = megafusion_blockers(g)
    assert [(label, "host-code" in why) for _, label, why in blockers] == [
        ("host", True)]
    g2 = Graph()
    g2, d = g2.add_node(DatasetOperator(data), [])
    g2, a = g2.add_node(_port_fusable("A"), [d])
    g2, b = g2.add_node(_port_fusable("B"), [a])
    g2, _ = g2.add_sink(b)
    assert megafusion_blockers(g2) == []


def test_megafused_transformer_pickles_without_graphs():
    mega = MegafusedBatchTransformer([NormalizeRows()])
    mega._graphs["k"] = object()
    mega._eager_calls["k"] = 1
    back = pickle.loads(pickle.dumps(mega))
    assert back._graphs == {} and back._eager_calls == {}
    x = torch.rand((5, 3)) + 0.1
    torch.testing.assert_close(back.batch_fn()(x), mega.batch_fn()(x))
