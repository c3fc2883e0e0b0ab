"""The port's optimizer on the CPU: `tests/test_optimizer.py`'s cases on
port nodes, and plan parity with the JAX package.

Plan parity: RandomPatchCifar, LinearPixels and MnistRandomFFT are built
small in both packages from the same numpy-seeded data, and after each of
the batches ``state``, ``cse``, ``fuse`` and ``node-opt`` the port's
`DefaultOptimizer(megafuse=m)` must hold the same number of nodes, with
the same operator class names in `linearize` order, as JAX's
`DefaultOptimizer(megafuse=m, sharding_planner=False,
precision_planner=False, unified_planner=False)`, for ``m`` off and on. No name mapping is
needed: each port class carries its JAX twin's name. JAX's ``unified``
batch (with the planner off, a rule that clears a planned chunk size)
has no port counterpart and is skipped.

`profile_nodes` is tested on a fake clock: its JAX counterpart reads the
wall clock and is one of the unsteady tests (ROADMAP queue 3).
"""

import gc

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.images.core import (
    GrayScaler as JaxGray,
    ImageVectorizer as JaxVectorizer,
    PixelScaler as JaxPixel,
)
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBCD,
    LinearMapEstimator as JaxLinearMapEstimator,
)
from keystone_tpu.nodes.stats import (
    LinearRectifier as JaxRectifier,
    PaddedFFT as JaxFFT,
    RandomSignNode as JaxSign,
)
from keystone_tpu.nodes.util import (
    Cacher as JaxCacher,
    ClassLabelIndicatorsFromInt as JaxIndicators,
    MaxClassifier as JaxMax,
    VectorCombiner as JaxCombiner,
)
from keystone_tpu.nodes.util.fusion import FusedBatchTransformer as JaxFBT
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import random_patch_cifar as jax_rpc
from keystone_tpu.workflow import (
    DefaultOptimizer as JaxDefaultOptimizer,
    Pipeline as JaxPipeline,
)
from keystone_tpu.workflow.analysis import linearize as jax_linearize
from keystone_tpu.workflow.graph import NodeId as JaxNodeId
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.pipelines import cifar_variants as cv
from keystone_tpu_torch.pipelines import mnist_random_fft as mnist
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
from keystone_tpu_torch.workflow import (
    AutoCacheRule,
    AutoCachingOptimizer,
    CacheMarker,
    DatasetOperator,
    DefaultOptimizer,
    Estimator,
    Graph,
    ItemTransformer,
    NodeId,
    NodeOptimizationRule,
    OptimizableEstimator,
    Pipeline,
    PipelineEnv,
    Transformer,
)
from keystone_tpu_torch.workflow import autocache as ac
from keystone_tpu_torch.telemetry import instrument as port_instrument
from keystone_tpu_torch.workflow.analysis import linearize
from keystone_tpu_torch.workflow.autocache import (
    Profile,
    estimate_cached_run_time,
    get_runs,
    profile_nodes,
)
from keystone_tpu_torch.workflow.optimizer import run_batch


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _rows(values):
    return Dataset(np.asarray(values, np.float32), device="cpu")


class Upper(ItemTransformer):
    def apply(self, x):
        return x.upper()


def test_host_dataset_routed_to_batch_path():
    out = Upper()(HostDataset(["a", "b"], device="cpu")).get()
    assert isinstance(out, HostDataset) and out.items == ["A", "B"]


def test_host_dataset_through_gather():
    out = Pipeline.gather([Upper(), Upper()])(
        HostDataset(["x"], device="cpu")).get()
    assert out.items == [["X", "X"]]


def test_autocaching_optimizer_instantiates_and_runs():
    PipelineEnv.get().set_optimizer(AutoCachingOptimizer(strategy="aggressive"))
    p = Transformer.from_function(lambda x: x + 1).to_pipeline()
    out = p(_rows(np.ones((8, 2)))).get()
    np.testing.assert_allclose(out.numpy(), 2 * np.ones((8, 2)))


class MeanEstimator(Estimator):
    n_fits = 0

    def fit(self, data):
        MeanEstimator.n_fits += 1
        mu = float(data.array.mean())
        return Transformer.from_function(lambda x: x - mu)


def test_prefix_identity_survives_gc_address_reuse():
    """Freed estimators and datasets never collide with new objects at
    the same address (`IdentityKey` holds its object)."""
    start_fits = MeanEstimator.n_fits
    outs = []
    for i in range(4):
        est = MeanEstimator()
        train = _rows(np.full((4, 1), float(i)))
        p = Transformer.from_function(lambda x: x).to_pipeline().and_then(
            est, train)
        outs.append(float(p(torch.tensor(10.0)).get()))
        del est, train, p
        gc.collect()
    assert outs == [10.0, 9.0, 8.0, 7.0]
    assert MeanEstimator.n_fits - start_fits == 4


# ---- auto-caching ------------------------------------------------------------


class WeightedIdentity(Transformer):
    def __init__(self, weight):
        self.weight = weight

    def apply_batch(self, data):
        return data


def _ident(name):
    return Transformer.from_function(lambda x: x, name=name)


def _diamond_graph():
    """data -> f -> {a, b}, each read by a sink."""
    g = Graph()
    g, data = g.add_node(DatasetOperator(_rows(np.ones((8, 2)))), [])
    g, f = g.add_node(_ident("f"), [data])
    g, a = g.add_node(_ident("a"), [f])
    g, b = g.add_node(_ident("b"), [f])
    g, _ = g.add_sink(a)
    g, _ = g.add_sink(b)
    return g, data, f, a, b


def _double_diamond_graph():
    """data -> f1 -> {a, b}, data -> f2 -> {c, d} (4 sinks)."""
    g = Graph()
    g, data = g.add_node(DatasetOperator(_rows(np.ones((8, 2)))), [])
    g, f1 = g.add_node(_ident("f1"), [data])
    g, a = g.add_node(_ident("a"), [f1])
    g, b = g.add_node(_ident("b"), [f1])
    g, f2 = g.add_node(_ident("f2"), [data])
    g, c = g.add_node(_ident("c"), [f2])
    g, d = g.add_node(_ident("d"), [f2])
    for leaf in (a, b, c, d):
        g, _ = g.add_sink(leaf)
    return g, f1, f2


def test_get_runs_counts_weighted_demand():
    g, data, f, a, b = _diamond_graph()
    runs = get_runs(g, cached=set())
    assert runs[a] == 1 and runs[b] == 1 and runs[f] == 2
    g2 = g.set_operator(a, WeightedIdentity(3))
    assert get_runs(g2, cached=set())[f] == 4  # 3 (weighted a) + 1 (b)
    assert get_runs(g2, cached={f})[f] == 1


def test_aggressive_cache_inserts_marker_on_shared_node():
    g, data, f, a, b = _diamond_graph()
    rule = AutoCacheRule(strategy="aggressive")
    g2, _ = rule.apply((g, {}))
    (c,) = [n for n in g2.nodes if isinstance(g2.get_operator(n),
                                              CacheMarker)]
    assert g2.get_dependencies(c) == (f,)
    assert g2.get_dependencies(a) == (c,) and g2.get_dependencies(b) == (c,)
    assert rule.chosen == [(f, "f")]


def test_estimate_cached_run_time():
    g, data, f, a, b = _diamond_graph()
    profiles = {f: Profile(1000.0, 1.0), a: Profile(10.0, 1.0),
                b: Profile(10.0, 1.0)}
    assert estimate_cached_run_time(g, set(), profiles) == 2 * 1000 + 20
    assert estimate_cached_run_time(g, {f}, profiles) == 1000 + 20


@pytest.mark.parametrize("budget,expect", [
    (10, set()),          # nothing fits
    (60, {"f2"}),         # only the small node fits
    (100, {"f1"}),        # best saving first; f2 no longer fits
    (149, {"f1"}),        # f2 still does not fit (100 + 50 > 149)
    (200, {"f1", "f2"}),  # both fit
])
def test_greedy_cache_across_memory_budgets(monkeypatch, budget, expect):
    """The greedy choice swept across budgets with the same synthetic
    profiles as the JAX package's test (reference
    AutocCacheRuleSuite.scala:74-181)."""
    g, f1, f2 = _double_diamond_graph()
    profiles = {f1: Profile(ns=1000.0, mem_bytes=100.0),
                f2: Profile(ns=600.0, mem_bytes=50.0)}
    monkeypatch.setattr(ac, "profile_nodes", lambda *a, **k: profiles)
    g2, _ = AutoCacheRule("greedy", mem_budget_bytes=budget).apply((g, {}))
    cached = {g2.get_operator(g2.get_dependencies(n)[0]).label
              for n in g2.nodes if isinstance(g2.get_operator(n),
                                              CacheMarker)}
    assert cached == expect


def test_greedy_default_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ac.device_budget_bytes() == float(1 << 30)
    assert AutoCacheRule("greedy")._budget() == float(1 << 30)
    with pytest.raises(ValueError):
        AutoCacheRule("sometimes")


class _FakeClock:
    """A `time` stand-in whose clock moves only when a node says so."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_profile_nodes_attributes_compute_to_slow_node(monkeypatch):
    """Each node's profile holds its own work: the slow node's 150 ms
    (on a fake clock) and the cheap node's 1 ms, extrapolated from two
    sample scales to the 64 rows; bytes are its output's."""
    clock = _FakeClock()
    monkeypatch.setattr(port_instrument, "perf_counter", clock.perf_counter)

    class Slow(Transformer):
        def apply_batch(self, data):
            clock.now += 0.15
            return data.map_batches(lambda a: a * 2.0)

    class Cheap(Transformer):
        def apply_batch(self, data):
            clock.now += 0.001
            return data.map_batches(lambda a: a + 1.0)

    result = (Slow().to_pipeline() >> Cheap())(_rows(np.ones((64, 4))))
    graph = result.executor.graph
    profiles = profile_nodes(graph, list(graph.operators), scales=(2, 4))
    by_name = {type(graph.get_operator(n)).__name__: p
               for n, p in profiles.items()}
    # constant in the sample size: the intercept, 150 ms and 1 ms
    assert by_name["Slow"].ns == pytest.approx(0.15e9)
    assert by_name["Cheap"].ns == pytest.approx(0.001e9)
    # bytes grow with the rows: 16 bytes a row, at 64 rows
    assert by_name["Slow"].mem_bytes == pytest.approx(64 * 16)


class RoutingEstimator(OptimizableEstimator):
    """Picks an implementation from the sample size (the cost-model
    routing pattern)."""

    def __init__(self):
        self.chosen = None
        self.sample_rows = None

    @property
    def default(self):
        return MeanEstimator()

    def optimize(self, sample, num_per_shard):
        self.sample_rows = sample.count
        self.chosen = "big" if num_per_shard > 10 else "small"
        return MeanEstimator()


@pytest.mark.parametrize("rows,chosen", [(100, "big"), (8, "small")])
def test_node_optimization_rule_consults_sample(rows, chosen):
    """One card is one shard: the estimator sees 3 sampled rows and the
    full row count as the count a shard."""
    est = RoutingEstimator()
    train = _rows(np.arange(rows * 8).reshape(rows, 8))
    p = Transformer.from_function(lambda x: x).to_pipeline().and_then(
        est, train)
    p(train).get()
    assert est.chosen == chosen and est.sample_rows == 3
    assert NodeOptimizationRule().samples_per_shard == 3


def test_dataset_sample_and_shard_counts():
    ds = _rows(np.arange(20).reshape(10, 2))
    assert ds.per_shard_count == 10 and ds.cache() is ds
    np.testing.assert_array_equal(ds.sample_per_shard(3).numpy(),
                                  ds.numpy()[[0, 4, 9]])
    host = HostDataset(list("abcdefghij"), device="cpu")
    assert host.per_shard_count == 10 and host.cache() is host
    assert host.sample_per_shard(3).items == ["a", "e", "j"]
    assert host.sample_per_shard(0).items == []


# ---- plan parity with the JAX package ---------------------------------------

PARITY_BATCHES = ("state", "cse", "fuse", "node-opt")


def _plan_trace(optimizer, graph, linearize_fn, node_type):
    """[(batch, node count, class names in linearize order)] after each
    of PARITY_BATCHES."""
    plan, out = (graph, {}), []
    for batch in optimizer.batches:
        plan = _run(batch, plan, optimizer)
        if batch.name in PARITY_BATCHES:
            g = plan[0]
            out.append((batch.name, len(g.operators), [
                type(g.get_operator(v)).__name__ for v in linearize_fn(g)
                if isinstance(v, node_type)]))
    return out


def _run(batch, plan, optimizer):
    if isinstance(optimizer, DefaultOptimizer):
        return run_batch(batch, plan)
    for _ in range(batch.max_iterations):
        new_plan = plan
        for rule in batch.rules:
            new_plan = rule.apply(new_plan)
        if optimizer._plans_equal(new_plan, plan):
            break
        plan = new_plan
    return plan


@pytest.fixture
def one_device_mesh():
    with use_mesh(make_mesh(jax.devices()[:1])) as mesh:
        yield mesh


def _cifar_pair(n_train=64, n_test=16):
    return (jax_synthetic(n_train, n_test, noise=1.2, confusion=0.6),
            synthetic_cifar(n_train, n_test, noise=1.2, confusion=0.6,
                            device="cpu"))


def _random_patch_cifar():
    (jtrain, _), (train, _) = _cifar_pair()
    cfg = dict(num_filters=8, block_size=64, sample_patches=1000)
    return (jax_rpc.build_pipeline(jtrain, jax_rpc.RandomPatchCifarConfig(
        **cfg)).graph,
        rpc.build_pipeline(train, rpc.RandomPatchCifarConfig(**cfg)).graph)


def _linear_pixels():
    (jtrain, _), (train, _) = _cifar_pair()
    labels = JaxIndicators(10)(jtrain.labels).get()
    jax_pipe = (JaxFBT([JaxPixel(), JaxGray(), JaxVectorizer()],
                       microbatch=4096).to_pipeline() >> JaxCacher("pixels")
                ).and_then(JaxLinearMapEstimator(1.0), jtrain.data, labels) \
        >> JaxMax()
    return jax_pipe.graph, cv.build_linear_pixels(
        train, cv.LinearPixelsConfig()).graph


def _mnist_random_fft():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(64, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=64).astype(np.int32)
    cfg = mnist.MnistRandomFFTConfig(num_ffts=3, block_size=64)
    branches = [JaxSign(32, seed=cfg.seed + i) >> JaxFFT() >> JaxRectifier(0.0)
                for i in range(cfg.num_ffts)]
    labels = JaxIndicators(10)(JaxDataset(y)).get()
    jax_pipe = (JaxPipeline.gather(branches) >> JaxCombiner()).and_then(
        JaxBCD(cfg.block_size, num_iter=1, lam=cfg.lam), JaxDataset(x),
        labels) >> JaxMax()
    train = LabeledData.from_arrays(y, x, "cpu")
    return jax_pipe.graph, mnist.build(train, cfg).graph


@pytest.mark.parametrize("megafuse", [False, True],
                         ids=["megafuse_off", "megafuse_on"])
@pytest.mark.parametrize("build", [_random_patch_cifar, _linear_pixels,
                                   _mnist_random_fft],
                         ids=["random_patch_cifar", "linear_pixels",
                              "mnist_random_fft"])
def test_plan_parity_with_jax_batch_by_batch(build, megafuse,
                                             one_device_mesh):
    jax_graph, port_graph = build()
    jax_opt = JaxDefaultOptimizer(megafuse=megafuse, sharding_planner=False,
                                  precision_planner=False,
                                  unified_planner=False)
    want = _plan_trace(jax_opt, jax_graph, jax_linearize, JaxNodeId)
    got = _plan_trace(DefaultOptimizer(megafuse=megafuse), port_graph,
                      linearize, NodeId)
    assert [b for b, _, _ in got] == list(PARITY_BATCHES)
    assert got == want


def test_plan_parity_shapes_the_slice():
    """RandomPatchCifar's optimized plan: CSE leaves one training
    featurization, and the apply path ends in one fused chain through
    the scaler's and the solver's apply boundaries; with megafusion (the
    default) that chain also takes in the source's featurizer and
    absorbs its Cacher."""
    _, graph = _random_patch_cifar()
    g, _ = DefaultOptimizer(megafuse=False).execute(graph)
    labels = [g.get_operator(v).label for v in linearize(g)
              if isinstance(v, NodeId)]
    assert labels.count("Cacher[features]") == 2  # train, and the source's
    assert labels[-1] == "Fused[fit:0 >> fit:1 >> MaxClassifier]"
    g, _ = DefaultOptimizer().execute(graph)
    labels = [g.get_operator(v).label for v in linearize(g)
              if isinstance(v, NodeId)]
    assert labels.count("Cacher[features]") == 1  # train's only
    assert labels[-1] == (
        "Megafused[Fused[PixelScaler >> Convolver >> SymmetricRectifier >> "
        "Pooler >> ImageVectorizer] >> fit:0 >> fit:1 >> MaxClassifier]")


def test_fused_transformers_tag_their_own_kernel_runs():
    """The fusion pass's fused transformers tag their chain-kernel run as
    a pipeline's own do: VOC's `PixelScaler >> GrayScaler` is one run,
    and a nested fused transformer is one opaque stage, which no run
    spans, with its own tag inside."""
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
        PixelScaler,
    )
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    images = Dataset(np.random.default_rng(0).uniform(
        0, 255, (5, 6, 6, 3)).astype(np.float32), device="cpu")

    def fused(pipe):
        result = pipe(images)
        ops = [op for op in result.executor.optimized_graph.operators.values()
               if isinstance(op, FusedBatchTransformer)]
        return ops, result.get().array

    want = GrayScaler().batch_fn()(PixelScaler().batch_fn()(images.array))
    (gray,), got = fused(PixelScaler() >> GrayScaler())
    assert gray.planned_kernel == (0, 2, "elementwise_chain")
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    inner = FusedBatchTransformer([PixelScaler(), GrayScaler()])
    (outer,), got = fused(inner >> ImageVectorizer())
    assert outer.stages[0] is inner
    assert outer.planned_kernel is None
    assert inner.planned_kernel == (0, 2, "elementwise_chain")
    torch.testing.assert_close(got, want.reshape(5, -1), rtol=0, atol=0)


def test_cse_reaches_its_fixpoint_on_chains_deeper_than_ten():
    """Two copies of a 12-stage chain over one dataset collapse into one
    in the port's `cse` batch; JAX's rule merges one level an
    application and its batch stops after 10, leaving duplicates (the
    VOCSIFTFisher graph hit this and fit its GMM twice; ROADMAP
    queue 3)."""
    from keystone_tpu.workflow import Graph as JaxGraph
    from keystone_tpu.workflow.operators import (
        DatasetOperator as JaxDatasetOperator,
    )
    from keystone_tpu.workflow.pipeline import Transformer as JaxTransformer

    def doubled_chain(graph_cls, dataset_op, transformer_cls, data):
        stages = [transformer_cls.from_function(abs, name=f"s{i}")
                  for i in range(12)]
        g = graph_cls()
        for _ in range(2):
            g, prev = g.add_node(dataset_op(data), [])
            for s in stages:
                g, prev = g.add_node(s, [prev])
            g, _ = g.add_sink(prev)
        return g

    port = doubled_chain(Graph, DatasetOperator, Transformer,
                         _rows(np.ones((2, 2))))
    ref = doubled_chain(JaxGraph, JaxDatasetOperator, JaxTransformer,
                        JaxDataset(np.ones((2, 2), np.float32)))
    cse = DefaultOptimizer().batches[1]
    jax_cse = JaxDefaultOptimizer(
        megafuse=False, sharding_planner=False, precision_planner=False,
        unified_planner=False).batches[1]
    assert cse.name == jax_cse.name == "cse"
    assert cse.max_iterations == jax_cse.max_iterations == 10
    assert len(run_batch(cse, (port, {}))[0].operators) == 13
    jax_graph = _run(jax_cse, (ref, {}), JaxDefaultOptimizer(
        megafuse=False, sharding_planner=False, precision_planner=False,
        unified_planner=False))[0]
    assert len(jax_graph.operators) > 13
