"""The port's workflow runtime on the CPU: the concurrent scheduler,
`execute_stream`, warm-ups, and the fusion cases of
`tests/test_scheduler.py:44-436` that need no telemetry, held against
the JAX package where both compute a value.

The scheduler's guarantees: the same values at any worker count, the
serial path's exception and retry behaviour, each vertex forced once,
fit once, and chunk streams kept lazy through fused chains. Warm-ups
run on the card only; here `_warmable` is patched to take CPU datasets
where a test drives one. Every thread a test starts is joined with a
timeout and asserted dead; no test sleeps.
"""

import threading

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.stats import (
    LinearRectifier as JaxRectifier,
    RandomSignNode as JaxSign,
)
from keystone_tpu.nodes.util import VectorCombiner as JaxCombiner
from keystone_tpu.workflow import Pipeline as JaxPipeline
from keystone_tpu.workflow import PipelineEnv as JaxPipelineEnv
from keystone_tpu.workflow import Transformer as JaxTransformer
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.learning import LinearMapEstimator
from keystone_tpu_torch.nodes.stats.normalization import (
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.nodes.stats.random_features import (
    LinearRectifier,
    RandomSignNode,
)
from keystone_tpu_torch.nodes.stats.scalers import StandardScaler
from keystone_tpu_torch.nodes.util.basic import (
    ClassLabelIndicatorsFromInt,
    Densify,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    MegafusedBatchTransformer,
)
from keystone_tpu_torch.utils import batching
from keystone_tpu_torch.workflow import (
    DatasetOperator,
    DefaultOptimizer,
    Estimator,
    Graph,
    Pipeline,
    PipelineEnv,
    Transformer,
)
from keystone_tpu_torch.workflow import executor as executor_mod
from keystone_tpu_torch.workflow.env import (
    config_override,
    dispatch_override,
    overlap_override,
)
from keystone_tpu_torch.workflow.executor import concurrent_relation
from keystone_tpu_torch.workflow.fusion_rule import NodeFusionRule

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_env():
    PipelineEnv.reset()
    JaxPipelineEnv.reset()
    yield
    PipelineEnv.reset()
    JaxPipelineEnv.reset()
    executor_mod.drain_warmups(timeout=30.0)
    assert not _runtime_threads()


def _count(name: str) -> float:
    """A process-wide counter of the port's metrics registry."""
    from keystone_tpu_torch.telemetry import counter

    return counter(name).value


def _runtime_threads():
    return [t for t in threading.enumerate() if t.is_alive() and t.name in (
        "keystone-prefetch", "keystone-warmup") or (
            t.is_alive() and t.name.startswith("keystone-dispatch"))]


def _unfused_optimizer():
    opt = DefaultOptimizer(megafuse=False)
    opt._batches = [b for b in opt._batches if b.name != "fuse"]
    return opt


def _gather_pipeline(width=4):
    branches = [Transformer.from_function((lambda k: lambda x: x * (k + 1.0))
                                          (i), name=f"scale{i}")
                for i in range(width)]
    return Pipeline.gather(branches) >> VectorCombiner()


def _jax_gather_pipeline(width=4):
    branches = [JaxTransformer.from_function(
        (lambda k: lambda x: x * (k + 1.0))(i), name=f"scale{i}")
        for i in range(width)]
    return JaxPipeline.gather(branches) >> JaxCombiner()


def test_deterministic_across_worker_counts():
    X = np.arange(32, dtype=np.float32).reshape(8, 4)
    pipe = _gather_pipeline()
    with dispatch_override(False):
        reference = pipe(Dataset(X, device=CPU)).get().numpy()
    want = np.asarray(_jax_gather_pipeline()(JaxDataset.from_numpy(X))
                      .get().numpy())[:8]
    np.testing.assert_array_equal(reference, want)
    for workers in (1, 2, 4):
        PipelineEnv.reset()
        with dispatch_override(True, workers=workers):
            out = pipe(Dataset(X, device=CPU)).get().numpy()
        np.testing.assert_array_equal(out, reference)


def test_scheduler_actually_ran():
    before = _count("dispatch.scheduler_runs")
    with dispatch_override(True, workers=4):
        _gather_pipeline()(Dataset(np.ones((8, 4), np.float32),
                                   device=CPU)).get()
    assert _count("dispatch.scheduler_runs") > before
    with dispatch_override(True, workers=1):
        runs = _count("dispatch.scheduler_runs")
        _gather_pipeline()(Dataset(np.ones((8, 4), np.float32),
                                   device=CPU)).get()
    assert _count("dispatch.scheduler_runs") == runs  # one worker is serial


class _Boom(Transformer):
    def batch_fn(self):
        def fn(x):
            raise RuntimeError("boom at force time")

        return fn


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_exception_propagation_matches_serial(workers):
    ds = Dataset(np.ones((8, 4), np.float32), device=CPU)
    pipe = Pipeline.gather([
        Transformer.from_function(lambda x: x, name="ok"),
        _Boom().to_pipeline(),
    ]) >> VectorCombiner()
    with dispatch_override(False):
        with pytest.raises(RuntimeError, match="boom at force time"):
            pipe(ds).get()
    PipelineEnv.reset()
    with dispatch_override(True, workers=workers):
        res = pipe(ds)
        with pytest.raises(RuntimeError, match="boom at force time"):
            res.get()
        # the failing expression stays unforced: a retry re-raises
        with pytest.raises(RuntimeError, match="boom at force time"):
            res.get()


def test_earliest_failure_in_topological_order_wins():
    """Two failing branches: the failure of the vertex a serial force
    reaches first is raised, at any worker count."""

    class _Named(Transformer):
        def __init__(self, msg):
            self.msg = msg

        def batch_fn(self):
            def fn(x):
                raise RuntimeError(self.msg)

            return fn

    pipe = Pipeline.gather([_Named("first").to_pipeline(),
                            _Named("second").to_pipeline()]) >> \
        VectorCombiner()
    ds = Dataset(np.ones((4, 2), np.float32), device=CPU)
    with dispatch_override(False):
        with pytest.raises(RuntimeError) as serial:
            pipe(ds).get()
    for workers in (2, 4):
        PipelineEnv.reset()
        with dispatch_override(True, workers=workers):
            with pytest.raises(RuntimeError) as err:
                pipe(ds).get()
        assert str(err.value) == str(serial.value)


class _CountingEstimator(Estimator):
    def __init__(self):
        self.fits = 0
        self._lock = threading.Lock()

    def fit(self, data):
        with self._lock:
            self.fits += 1
        mu = float(data.numpy().mean())
        return Transformer.from_function(lambda x: x - mu, name="center")


def test_single_force_and_fit_once_under_concurrency():
    """A shared node with two consumers is forced once; re-applying the
    pipeline never refits (prefix reuse), with the pool on."""
    forces = []
    lock = threading.Lock()
    shared = Transformer.from_function(lambda x: x * 2.0, name="shared")
    orig_batch = shared.batch_transform

    def counting_batch(inputs):
        with lock:
            forces.append(threading.get_ident())
        return orig_batch(inputs)

    shared.batch_transform = counting_batch
    est = _CountingEstimator()
    train = Dataset(np.ones((8, 2), np.float32), device=CPU)
    featurize = Pipeline.gather([
        shared.to_pipeline() >> Transformer.from_function(
            lambda x: x + 1.0, name="a"),
        shared.to_pipeline() >> Transformer.from_function(
            lambda x: x + 2.0, name="b"),
    ]) >> VectorCombiner()
    pipe = featurize.and_then(est, train)
    with dispatch_override(True, workers=4):
        out1 = pipe(train).get().numpy()
        assert len(forces) == 1, "shared node forced more than once"
        assert est.fits == 1
        out2 = pipe(train).get().numpy()
    assert est.fits == 1, "prefix reuse failed: estimator refit"
    np.testing.assert_array_equal(out1, out2)


class _ChunkProducer(Transformer):
    """A bucketed host stage that streams its chunks (SIFT's pattern)."""

    def batch_fn(self):
        return lambda x: x * 2.0

    def apply_batch_stream(self, data):
        return batching.map_host_batched_stream(
            data.items, lambda xb: xb * 2.0, chunk=2, device=CPU)


def test_streaming_flows_through_fused_chain():
    """NormalizeRows >> SignedHellingerMapper fuse into one chain; fed
    by a stream-producing stage under the pool it keeps yielding
    several index-carrying chunks, equal to the unfused serial run."""
    rng = np.random.default_rng(0)
    items = [rng.normal(size=(6,)).astype(np.float32) for _ in range(8)]
    pipe = (_ChunkProducer().to_pipeline()
            >> NormalizeRows() >> SignedHellingerMapper())
    with overlap_override(False):
        PipelineEnv.get().set_optimizer(_unfused_optimizer())
        serial = pipe(HostDataset(items, device=CPU)).get()
    PipelineEnv.reset()
    with overlap_override(True, prefetch_depth=1), \
            dispatch_override(True, workers=4):
        res = pipe(HostDataset(items, device=CPU))
        fused_labels = [
            op.label for op in res.executor.optimized_graph.operators.values()
            if op.label.startswith("Fused[")]
        assert any("NormalizeRows" in l and "SignedHellingerMapper" in l
                   for l in fused_labels), fused_labels
        seen, n_chunks = {}, 0
        for idxs, payload in res.stream():
            assert idxs is not None, "stream materialized at the fused stage"
            n_chunks += 1
            for i, item in zip(idxs, payload):
                seen[i] = item
        assert n_chunks >= 2
    for i in range(len(items)):
        np.testing.assert_allclose(serial.items[i].numpy(),
                                   seen[i].numpy(), rtol=1e-5)


def test_fused_batch_transformer_chunkable_property():
    assert FusedBatchTransformer(
        [NormalizeRows(), SignedHellingerMapper()]).chunkable
    assert not FusedBatchTransformer([NormalizeRows(), Densify()]).chunkable


def _fusable_fn(name):
    class _F(Transformer):
        fusable = True

        @property
        def label(self):
            return name

        def batch_fn(self):
            return lambda x: x + 1.0

    return _F()


def test_fusion_never_crosses_fanout():
    g = Graph()
    g, data = g.add_node(DatasetOperator(
        Dataset(np.ones((4, 2), np.float32), device=CPU)), [])
    g, a = g.add_node(_fusable_fn("A"), [data])
    g, b = g.add_node(_fusable_fn("B"), [a])
    g, c = g.add_node(_fusable_fn("C"), [b])
    g, d = g.add_node(_fusable_fn("D"), [b])
    g, _ = g.add_sink(c)
    g, _ = g.add_sink(d)
    g2, _ = NodeFusionRule().apply((g, {}))
    labels = sorted(op.label for op in g2.operators.values()
                    if not op.label.startswith("Dataset"))
    assert labels == ["C", "D", "Fused[A >> B]"], labels


def test_chain_discovery_insensitive_to_id_order():
    ds = Dataset(np.ones((4, 2), np.float32), device=CPU)

    def fused_labels(g):
        g2, _ = NodeFusionRule().apply((g, {}))
        return sorted(op.label for op in g2.operators.values()
                      if op.label.startswith("Fused["))

    g = Graph()
    g, data = g.add_node(DatasetOperator(ds), [])
    g, a = g.add_node(_fusable_fn("A"), [data])
    g, b = g.add_node(_fusable_fn("B"), [a])
    g, c = g.add_node(_fusable_fn("C"), [b])
    g, _ = g.add_sink(c)
    forward = fused_labels(g)
    g = Graph()
    g, data = g.add_node(DatasetOperator(ds), [])
    g, c = g.add_node(_fusable_fn("C"), [data])
    g, b = g.add_node(_fusable_fn("B"), [data])
    g, a = g.add_node(_fusable_fn("A"), [data])
    g = g.set_dependencies(b, [a]).set_dependencies(c, [b])
    g, _ = g.add_sink(c)
    assert forward == fused_labels(g) == ["Fused[A >> B >> C]"]


def test_fused_chain_fit_produces_clean_fitted_pipeline():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(16, 5)).astype(np.float32)
    Y = (2.0 * np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)] - 1.0)
    train = Dataset(X, device=CPU)
    pipe = (Transformer.from_function(lambda x: x * 1.0, name="ident")
            .to_pipeline()
            .and_then(StandardScaler(), train)
            .and_then(LinearMapEstimator(0.1), train, Dataset(Y, device=CPU))
            >> MaxClassifier())
    lazy = pipe(train).get().numpy()
    fitted = pipe.fit()
    np.testing.assert_array_equal(fitted(train).numpy(), lazy)


def _apply_dispatches(build, test, monkeypatch, optimizer):
    """(batch calls of the apply run, its output): the fit runs first,
    then the apply run's `Transformer.batch_transform` calls are
    counted."""
    PipelineEnv.reset()
    PipelineEnv.get().set_optimizer(optimizer)
    pipe, train = build()
    pipe(train).get()
    calls = []
    real = Transformer.batch_transform

    def counting(self, inputs):
        calls.append(self.label)
        return real(self, inputs)

    monkeypatch.setattr(Transformer, "batch_transform", counting)
    out = pipe(test).get().numpy()
    monkeypatch.setattr(Transformer, "batch_transform", real)
    return len(calls), out


@pytest.mark.parametrize("example", ["random_patch_cifar",
                                     "mnist_random_fft"])
def test_dispatch_reduction_at_least_2x(example, monkeypatch):
    """The default plan runs the apply path in at least 2× fewer batch
    calls than the unfused plan (one, megafused), with equal outputs."""
    if example == "random_patch_cifar":
        from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
        from keystone_tpu_torch.pipelines import random_patch_cifar as rpc

        train, test = synthetic_cifar(64, 16, noise=1.2, confusion=0.6,
                                      device="cpu")
        cfg = rpc.RandomPatchCifarConfig(num_filters=8, microbatch=16)

        def build():
            return rpc.build_pipeline(train, cfg), train.data

        test_data = test.data
    else:
        from keystone_tpu_torch.loaders.csv_loader import LabeledData
        from keystone_tpu_torch.pipelines import mnist_random_fft as mnist

        rng = np.random.default_rng(0)
        x = rng.uniform(size=(64, 32)).astype(np.float32)
        y = rng.integers(0, 10, size=64).astype(np.int32)
        labeled = LabeledData.from_arrays(y, x, "cpu")
        cfg = mnist.MnistRandomFFTConfig(num_ffts=3, block_size=64)

        def build():
            return mnist.build(labeled, cfg), labeled.data

        test_data = Dataset(rng.uniform(size=(20, 32)).astype(np.float32),
                            device=CPU)
    base, base_out = _apply_dispatches(build, test_data, monkeypatch,
                                       _unfused_optimizer())
    opt, opt_out = _apply_dispatches(build, test_data, monkeypatch,
                                     DefaultOptimizer())
    assert opt == 1 and base / opt >= 2.0, (base, opt)
    np.testing.assert_array_equal(opt_out, base_out)


def test_fused_chain_masks_padded_rows():
    """A fused chain through the scaler's and the solver's fits gives the
    unfused path's model at a count that is no multiple of anything."""
    rng = np.random.default_rng(7)
    n, d, k = 43, 6, 3
    X = np.abs(rng.normal(size=(n, d))).astype(np.float32) + 1.0
    y = rng.integers(0, k, n).astype(np.int32)

    def run(optimizer):
        PipelineEnv.reset()
        PipelineEnv.get().set_optimizer(optimizer)
        train = Dataset(X, device=CPU)
        labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=CPU)).get()
        pipe = (NormalizeRows().to_pipeline()
                .and_then(StandardScaler(), train)
                .and_then(LinearMapEstimator(0.1), train, labels))
        out = pipe(train).get().numpy()
        PipelineEnv.reset()
        return out

    with overlap_override(False), dispatch_override(False):
        reference = run(_unfused_optimizer())
    np.testing.assert_allclose(run(DefaultOptimizer()), reference,
                               rtol=1e-5, atol=1e-6)


def test_gather_diamond_fuses_to_one_program():
    """The MnistRandomFFT-shaped diamond collapses into one Gather[...]
    stage, equal to the unfused path and to the JAX package's values."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(21, 8)).astype(np.float32)
    pipe = Pipeline.gather([
        RandomSignNode(8, seed=i, device=CPU).to_pipeline()
        >> LinearRectifier(0.0)
        for i in range(3)]) >> VectorCombiner()
    with overlap_override(False), dispatch_override(False):
        PipelineEnv.get().set_optimizer(_unfused_optimizer())
        reference = pipe(Dataset(X, device=CPU)).get().numpy()
    PipelineEnv.reset()
    res = pipe(Dataset(X, device=CPU))
    labels = [op.label
              for op in res.executor.optimized_graph.operators.values()]
    assert any("Gather[" in l for l in labels), labels
    np.testing.assert_allclose(res.get().numpy(), reference, rtol=1e-6)
    jax_pipe = JaxPipeline.gather([
        JaxSign(8, seed=i).to_pipeline() >> JaxRectifier(0.0)
        for i in range(3)]) >> JaxCombiner()
    want = np.asarray(jax_pipe(JaxDataset.from_numpy(X)).get().numpy())[:21]
    np.testing.assert_allclose(reference, want, rtol=1e-6, atol=1e-6)


def test_stats_transformers_declare_chunkable():
    """Every per-item transformer in nodes/stats declares ``chunkable``,
    as the JAX package's do; a new one must be classified here."""
    import inspect

    from keystone_tpu_torch.nodes.stats import (
        normalization,
        random_features,
        scalers,
    )

    elementwise = {
        "NormalizeRows", "SignedHellingerMapper", "ColumnSampler",
        "CosineRandomFeatures", "RandomSignNode", "PaddedFFT",
        "LinearRectifier", "StandardScalerModel"}
    whole_dataset = {"Sampler"}
    found = set()
    for mod in (normalization, random_features, scalers):
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if not issubclass(cls, Transformer) or cls is Transformer \
                    or cls.__module__ != mod.__name__:
                continue
            found.add(name)
            if name in elementwise:
                assert getattr(cls, "chunkable", False), name
            elif name in whole_dataset:
                assert not getattr(cls, "chunkable", False), name
            else:
                raise AssertionError(f"unclassified stats transformer {name}")
    assert elementwise | whole_dataset == found


# ---- execute_stream, the concurrent relation, warm-ups -----------------------


def test_execute_stream_of_a_device_pipeline_is_one_chunk():
    pipe = _gather_pipeline(2)
    res = pipe(Dataset(np.ones((4, 3), np.float32), device=CPU))
    chunks = list(res.executor.execute_stream(res.sink))
    assert len(chunks) == 1 and chunks[0][0] is None
    np.testing.assert_array_equal(chunks[0][1].numpy(), res.get().numpy())


def test_concurrent_relation():
    g = Graph()
    g, d = g.add_node(DatasetOperator(
        Dataset(np.ones((2, 2), np.float32), device=CPU)), [])
    g, a = g.add_node(_fusable_fn("A"), [d])
    g, b = g.add_node(_fusable_fn("B"), [d])
    g, c = g.add_node(_fusable_fn("C"), [a])
    unordered = concurrent_relation(g)
    assert unordered(a, b) and unordered(b, c)
    assert not unordered(a, c) and not unordered(d, c) and not unordered(a, a)


def _fitted_apply_pipeline():
    rng = np.random.default_rng(3)
    X = np.abs(rng.normal(size=(24, 6))).astype(np.float32) + 1.0
    y = rng.integers(0, 3, 24).astype(np.int32)
    train = Dataset(X, device=CPU)
    labels = ClassLabelIndicatorsFromInt(3)(Dataset(y, device=CPU)).get()
    pipe = (NormalizeRows().to_pipeline()
            .and_then(StandardScaler(), train)
            .and_then(LinearMapEstimator(0.1), train, labels)
            >> MaxClassifier())
    return pipe, train


def test_warmup_rearms_after_fit_resolution(monkeypatch):
    """A fused chain whose fits had not run at the warm scan is parked,
    and re-armed once they have: its materialized transformer (the one
    the force runs) is warmed, without a capture (``full=False``)."""
    warmed = []
    monkeypatch.setattr(executor_mod, "_warmable", lambda ds: True)

    def submit(op, ds, full=True):
        assert not full
        warmed.append((op, ds.count))

    monkeypatch.setattr(executor_mod, "_submit_warmup", submit)
    test = Dataset(np.ones((7, 6), np.float32), device=CPU)
    with config_override(aot_warmup=True):
        pipe, _ = _fitted_apply_pipeline()
        res = pipe(test)
        res.get()
        assert res.executor._warm_pending and not warmed
        res.executor.execute(res.sink)  # the next execute re-arms it
    assert [count for _, count in warmed] == [7]
    assert not res.executor._warm_pending
    warmed.clear()
    PipelineEnv.reset()
    with config_override(aot_warmup=True), dispatch_override(False):
        pipe, _ = _fitted_apply_pipeline()
        res = pipe(test)
        ex = res.executor
        res.get()
        assert ex._warm_pending and not warmed
        ex._rearm_warmup()  # what the next execute() runs
    assert not ex._warm_pending
    assert [count for _, count in warmed] == [7]
    (op, _), = warmed
    assert isinstance(op, MegafusedBatchTransformer)
    chain = [o for o in ex.optimized_graph.operators.values()
             if type(o).__name__ == "MegafusedPlanOperator"]
    fits = [ex._memo[d].get for d in ex.optimized_graph.get_dependencies(
        [v for v in ex.optimized_graph.operators
         if ex.optimized_graph.get_operator(v) is chain[0]][0])[:-1]]
    assert chain[0].materialize(fits) is op  # the force's own transformer


def test_warmup_runs_uncounted_and_failures_are_counted(monkeypatch):
    """A warm-up of a fused chain over a bound dataset runs the chain
    once without counting its microbatches; a warm-up that raises is
    counted and execution goes on with the right value."""
    monkeypatch.setattr(executor_mod, "_warmable", lambda ds: True)
    fbt = FusedBatchTransformer([NormalizeRows(), SignedHellingerMapper()],
                                microbatch=4)
    X = np.abs(np.random.default_rng(1).normal(size=(10, 5))).astype(
        np.float32) + 0.1
    ds = Dataset(X, device=CPU)
    with config_override(aot_warmup=True):
        res = fbt(ds)
        expr = res.executor.execute(res.sink)
        executor_mod.drain_warmups(timeout=30.0)
        assert fbt.microbatches_run == 0
        out = expr.get.numpy()
        assert fbt.microbatches_run == 3
    failures = _count("dispatch.warmup_failures")

    def broken(*args, **kwargs):
        raise RuntimeError("warm-up failed (simulated)")

    bad = FusedBatchTransformer([NormalizeRows(), SignedHellingerMapper()])
    monkeypatch.setattr(bad, "warmup", broken)
    with config_override(aot_warmup=True):
        got = bad(ds).get().numpy()
        executor_mod.drain_warmups(timeout=30.0)
    assert _count("dispatch.warmup_failures") == failures + 1
    np.testing.assert_array_equal(got, out)
    with config_override(aot_warmup=False):
        before = _count("dispatch.warmup_failures")
        bad(ds).get()
        executor_mod.drain_warmups(timeout=30.0)
        assert _count("dispatch.warmup_failures") == before


def test_tally_loses_no_count_under_thread_switches():
    """The launch counters are shared by the scheduler's workers: 16
    threads adding 2,000 counts each, switching every microsecond, end
    at the exact total; a thread's sink keeps its counts apart."""
    import sys

    from keystone_tpu_torch.telemetry.metrics import tallied, tally

    class Counter:
        launches = 0

    apart = {}

    def work(sink):
        if sink is None:
            for _ in range(2000):
                tally(Counter)
        else:
            with tallied(sink):
                for _ in range(2000):
                    tally(Counter)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work,
                                    args=(apart if i == 0 else None,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert Counter.launches == 15 * 2000
    assert list(apart.values()) == [[Counter, "launches", 2000]]


def test_a_chain_of_tasks_starts_no_pool():
    """Where each task of the schedule waits for the one before it, the
    force stays on the caller's thread (no pool, the same value); two
    independent branches start the pool."""
    from keystone_tpu_torch.workflow.executor import _sequential

    X = np.abs(np.random.default_rng(2).normal(size=(12, 4))).astype(
        np.float32) + 1.0
    y = np.arange(12, dtype=np.int32) % 3
    train = Dataset(X, device=CPU)
    labels = ClassLabelIndicatorsFromInt(3)(Dataset(y, device=CPU)).get()
    pipe = (Transformer.from_function(lambda x: x * 2.0, name="double")
            .to_pipeline()
            .and_then(LinearMapEstimator(0.1), train, labels))
    with dispatch_override(False):
        reference = pipe(train).get().numpy()
    PipelineEnv.reset()
    runs = _count("dispatch.scheduler_runs")
    with dispatch_override(True, workers=4):
        res = pipe(train)
        out = res.get().numpy()
        graph = res.executor.optimized_graph
        tasks, eff = res.executor._schedule_plan(res.sink, graph)
    assert _count("dispatch.scheduler_runs") == runs
    np.testing.assert_array_equal(out, reference)
    assert _sequential(["a", "b", "c"], {"a": set(), "b": {"a"},
                                         "c": {"b"}})
    assert not _sequential(["a", "b", "c"], {"a": set(), "b": set(),
                                             "c": {"a", "b"}})
