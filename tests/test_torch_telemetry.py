"""The port's telemetry (`keystone_tpu_torch/telemetry/`) on the CPU:
spans, metrics, the Chrome trace, the shared node-force instrumentation,
compile accounting, and parity with the JAX package's telemetry.

Mirrors `tests/test_telemetry.py` where the port has the part (span
nesting, the no-op span, exception paths, the profiler's failure
accounting, the trace's schema and categories, streamed stages, the
per-run live peak, the overlap queue bounds, the producer's failure,
auto-caching on the shared profiles, `profile_execution`, the executor's
counters). Its per-process cases wait for multi-GPU runs (ROADMAP
queue 1, item 4); the memory reconciliation is in
`tests/test_torch_reconcile.py`.

Parity with the JAX package:

- one recorded span sequence fed to both `Tracer`s gives the same
  Chrome trace up to timestamps, pids, tids and the process name;
- a JAX-written trace gives the same summary text through both CLIs,
  its reconciliation sections (static estimates against the trace)
  included, and so does a port-written one;
- a small RandomPatchCifar (JAX's filters carried across), fit and
  applied under each package's `trace_run`, gives the same node-span
  labels, the same fusion, megafusion and cache decision keys and the
  same ``dispatch.programs_executed`` (8 each): both unified planners
  record one ``cache`` decision (``Cacher[features];DelegatingOperator``)
  and force the two `CacheMarker` nodes they insert (``force
  Cache[...]``). JAX's trace also carries ``compile`` spans (XLA
  compiles) where the port compiles nothing on the CPU.
"""

import json
import threading
import time as _time

import numpy as np
import pytest
import torch

import jax

from keystone_tpu import telemetry as jax_telemetry
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import random_patch_cifar as jax_rpc
from keystone_tpu.telemetry.__main__ import main as jax_cli
from keystone_tpu.workflow import PipelineEnv as JaxPipelineEnv
from keystone_tpu_torch import convert
from keystone_tpu_torch import telemetry
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.util.basic import (
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    MegafusedBatchTransformer,
)
from keystone_tpu_torch.nodes.stats.normalization import NormalizeRows
from keystone_tpu_torch.ops import _build
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
from keystone_tpu_torch.telemetry import (
    instrument,
    load_trace,
    registry,
    span,
    summarize,
    to_chrome_trace,
    trace_run,
)
from keystone_tpu_torch.telemetry.__main__ import main as port_cli
from keystone_tpu_torch.utils.batching import map_host_batched
from keystone_tpu_torch.utils.profiling import (
    ExecutionProfiler,
    profile_execution,
)
from keystone_tpu_torch.workflow import Pipeline, PipelineEnv, Transformer
from keystone_tpu_torch.workflow.env import (
    config_override,
    dispatch_override,
    overlap_override,
)
from keystone_tpu_torch.workflow.expressions import Expression

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_metrics():
    registry().reset()
    PipelineEnv.reset()
    yield
    registry().reset()
    PipelineEnv.reset()


# ---- span basics -------------------------------------------------------------


def test_span_nesting_and_parent_attribution():
    with trace_run() as tr:
        with span("outer", cat="phase", k=1):
            with span("inner_a", cat="step"):
                pass
            with span("inner_b", cat="step"):
                pass
    by_name = {s.name: s for s in tr.spans}
    root, outer = by_name["pipeline_run"], by_name["outer"]
    assert outer.parent == root.sid
    assert by_name["inner_a"].parent == outer.sid
    assert by_name["inner_b"].parent == outer.sid
    assert outer.args["k"] == 1
    assert outer.t0 <= by_name["inner_a"].t0
    assert (outer.t0 + outer.dur
            >= by_name["inner_b"].t0 + by_name["inner_b"].dur)


def test_span_noop_without_tracer():
    ctx = span("nothing", cat="node")
    with ctx as rec:
        assert rec is None
    assert not ctx


def test_exception_path_closes_spans():
    with pytest.raises(ValueError, match="boom"):
        with trace_run() as tr:
            with span("will_fail", cat="step"):
                raise ValueError("boom")
    failed = next(s for s in tr.spans if s.name == "will_fail")
    assert failed.error and failed.dur >= 0.0
    assert next(s for s in tr.spans if s.name == "pipeline_run").error
    with trace_run() as tr2:
        with span("fresh"):
            pass
    fresh = next(s for s in tr2.spans if s.name == "fresh")
    assert fresh.parent == next(
        s for s in tr2.spans if s.name == "pipeline_run").sid


def test_each_thread_gets_its_own_span_lane():
    """A span opened on another thread (a scheduler worker, the host
    stream's producer) is a root of its own lane, not a child of the
    main thread's open span."""
    with trace_run() as tr:
        with span("main", cat="phase"):
            def work():
                with span("worker", cat="chunk"):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    worker = next(s for s in tr.spans if s.name == "worker")
    main = next(s for s in tr.spans if s.name == "main")
    assert worker.parent is None and worker.tid != main.tid


def test_profiler_failure_keeps_elapsed_time_and_counts():
    prof = ExecutionProfiler()

    def bad_thunk():
        _time.sleep(0.05)
        raise RuntimeError("solver died")

    expr = prof.wrap("exploding", Expression(bad_thunk))
    with pytest.raises(RuntimeError, match="solver died"):
        expr.get
    p = prof.profiles["exploding"]
    assert p.forced == 1 and p.failures == 1
    assert p.seconds >= 0.04
    assert p.bytes == 0.0
    assert registry().counter("executor.node_failures").value == 1


def test_estimate_bytes_reads_shapes():
    x = torch.zeros((4, 3), dtype=torch.float32)
    assert instrument.estimate_bytes(x) == 48.0
    assert instrument.estimate_bytes(Dataset(x, device=CPU)) == 48.0
    host = HostDataset([np.zeros(5, np.float32), np.zeros(2, np.float64)],
                       device=CPU)
    assert instrument.estimate_bytes(host) == 36.0
    assert instrument.estimate_bytes(b"abcd") == 4.0
    assert instrument.estimate_bytes(object()) == 64.0


# ---- the trace ------------------------------------------------------------------


class _StreamScale(Transformer):
    """A host-batched stage that streams its chunks."""

    chunkable = True

    def apply(self, x):
        return x * 2.0

    def apply_batch_stream(self, data):
        from keystone_tpu_torch.utils import batching

        return batching.map_host_batched_stream(
            data.items, lambda X: X * 2.0, chunk=8, device=CPU)


class _ToDevice(Transformer):
    def apply(self, x):
        return x

    def apply_batch(self, data):
        return Dataset(torch.stack([torch.as_tensor(x) for x in data.items]),
                       device=CPU)


def _run_traced_pipeline(tmp_path, n=48, dim=12):
    """Chunk spans (the host stream), node forces and BCD steps."""
    rng = np.random.default_rng(7)
    X = [rng.normal(size=(dim,)).astype(np.float32) for _ in range(n)]
    y = rng.integers(0, 3, size=n).astype(np.int32)
    labels = ClassLabelIndicatorsFromInt(3)(Dataset(y, device=CPU)).get()
    path = str(tmp_path / "trace.json")
    with overlap_override(True, prefetch_depth=2):
        with trace_run(path):
            featurizer = _StreamScale().to_pipeline() >> _ToDevice()
            predictor = featurizer.and_then(
                BlockLeastSquaresEstimator(8, num_iter=2, lam=0.1),
                HostDataset(X, device=CPU), labels) >> MaxClassifier()
            predictor(HostDataset(X, device=CPU)).get()
    return path


def test_trace_json_is_valid_chrome_trace(tmp_path):
    trace = load_trace(_run_traced_pipeline(tmp_path))
    events = trace["traceEvents"]
    for e in events:
        assert "name" in e and "ph" in e and "pid" in e
        if e["ph"] == "X":
            assert isinstance(e["ts"], (int, float))
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
    json.loads(json.dumps(trace))
    cats = {e.get("cat") for e in events if e.get("ph") == "X"}
    assert {"pipeline", "phase", "node", "chunk", "step"} <= cats, cats
    steps = [e for e in events if e.get("cat") == "step"]
    assert len(steps) == 2 and all("parent_id" in e["args"] for e in steps)
    metrics = trace["keystone"]["metrics"]
    assert "prefetch.consumer_wait_s" in metrics["histograms"]
    assert metrics["counters"]["executor.node_forces"]["value"] > 0
    assert metrics["counters"]["solver.steps"]["value"] == 2
    assert trace["keystone"]["capabilities"]["device"]["reason"]
    # self-times never exceed the run's wall clock
    run = next(e for e in events if e.get("cat") == "pipeline")
    node_self = sum(a["self_s"] for a in telemetry.aggregate_spans(
        trace, "node").values())
    assert node_self * 1e6 <= run["dur"] + 1.0
    out = summarize(trace)
    assert "top node forces by self-time" in out
    assert "solver iterations" in out and "stream chunks" in out


def test_streamed_stage_gets_node_span_and_bytes():
    X = [np.ones((4,), np.float32) * i for i in range(32)]
    with overlap_override(True, prefetch_depth=2):
        with trace_run() as tr:
            pipe = _StreamScale().to_pipeline() >> Transformer.from_function(
                lambda x: x + 1.0, name="inc")
            out = pipe(HostDataset(X, device=CPU)).get()
    got = np.stack([np.asarray(x) for x in out.items])
    np.testing.assert_allclose(got, np.stack(X) * 2.0 + 1.0)
    node_spans = {s.name: s for s in tr.spans if s.cat == "node"}
    up = node_spans["force _StreamScale"]
    assert up.args.get("streamed") is True
    assert up.args.get("out_bytes") == 32 * 4 * 4
    window = up.args.get("drain_window_s")
    assert window is not None and window + 2e-6 >= up.dur


def test_observed_live_peak_is_per_run():
    data = Dataset(np.ones((16, 8), np.float32), device=CPU)

    def one_run():
        PipelineEnv.reset()
        with trace_run() as tr:
            Transformer.from_function(lambda x: x * 2.0)(data).get()
        return tr.metadata.get("observed_live_peak_bytes", 0.0)

    first = one_run()
    assert first > 0 and one_run() == pytest.approx(first)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_queue_depth_gauge_obeys_documented_bound(depth):
    """At most 2·depth + 2 chunks resident (`utils/batching.py`)."""
    items = [np.full((4,), i, np.float32) for i in range(64)]
    with config_override(megafusion=False), \
            overlap_override(True, prefetch_depth=depth):
        out = map_host_batched(items, lambda X: X * 2.0, chunk=4,
                               device=CPU)
    np.testing.assert_allclose(torch.stack(out).numpy(),
                               np.stack(items) * 2.0)
    reg = registry()
    assert reg.gauge("prefetch.queue_depth").max <= depth + 1
    assert reg.gauge("overlap.inflight_results").max <= depth + 1
    assert reg.gauge("overlap.resident_chunks").max <= 2 * depth + 2
    assert reg.counter("overlap.chunks_dispatched").value == 16
    assert reg.counter("dispatch.programs_executed").value == 16


def test_producer_exception_still_records_metrics_and_raises():
    items = [np.ones((4,), np.float32)] * 32

    def exploding(X):
        raise RuntimeError("device fell over")

    with config_override(megafusion=False), \
            overlap_override(True, prefetch_depth=2):
        with pytest.raises(RuntimeError, match="device fell over"):
            map_host_batched(items, exploding, chunk=4, device=CPU)
    assert registry().gauge("prefetch.queue_depth").max >= 0


# ---- profiles, auto-caching, the executor's counters -----------------------------


class _SlowShared(Transformer):
    def apply(self, x):
        _time.sleep(0.12)
        return x * 2.0

    def apply_batch(self, data):
        _time.sleep(0.12)
        return data.map_batches(lambda a: a * 2.0)


class _Cheap(Transformer):
    def apply(self, x):
        return x + 1.0

    def apply_batch(self, data):
        return data.map_batches(lambda a: a + 1.0)


def _shared_slow_graph():
    from keystone_tpu_torch.workflow.graph import Graph
    from keystone_tpu_torch.workflow.operators import DatasetOperator

    g = Graph()
    g, data = g.add_node(DatasetOperator(
        Dataset(np.ones((64, 4), np.float32), device=CPU)), [])
    g, slow = g.add_node(_SlowShared(), [data])
    g, a = g.add_node(_Cheap(), [slow])
    g, b = g.add_node(_Cheap(), [slow])
    g, _ = g.add_sink(a)
    g, _ = g.add_sink(b)
    return g, slow


def test_profile_nodes_gives_the_same_cache_choice(monkeypatch):
    """`profile_nodes` on the shared instrumentation: the 120 ms lands on
    the slow shared node, which greedy caching picks (as the old
    node profiler's readings did), and a replay of the rule on the same
    profiles makes the identical choice; the choice is one ledger
    ``cache`` decision."""
    import keystone_tpu_torch.workflow.autocache as ac
    from keystone_tpu_torch.telemetry import ledger

    g, slow = _shared_slow_graph()
    candidates = ac.AutoCacheRule._candidates(g)
    assert slow in candidates
    profiles = ac.profile_nodes(g, candidates, scales=(2, 4))
    assert profiles[slow].ns > 100e6 and profiles[slow].mem_bytes > 0
    live = ac.AutoCacheRule(strategy="greedy", mem_budget_bytes=1 << 20)
    mark = ledger.session_mark()
    live.apply((g, {}))
    assert [label for _, label in live.chosen] == ["_SlowShared"]
    (rec,) = [d for d in ledger.session_since(mark) if d["kind"] == "cache"]
    assert rec["labels"] == ["_SlowShared"]
    monkeypatch.setattr(ac, "profile_nodes", lambda *a, **k: profiles)
    replay = ac.AutoCacheRule(strategy="greedy", mem_budget_bytes=1 << 20)
    replay.apply((g, {}))
    assert replay.chosen == live.chosen


def test_profile_execution_report_still_works():
    data = Dataset(np.ones((16, 4), np.float32), device=CPU)
    pipe = Transformer.from_function(lambda x: x * 3.0,
                                     name="tripler").to_pipeline()
    with profile_execution() as prof:
        pipe(data).get()
    report = prof.report()
    assert "tripler" in report and "seconds" in report
    assert any(p.forced for p in prof.profiles.values())


def test_memo_and_prefix_counters_count_reuse():
    rng = np.random.default_rng(0)
    data = Dataset(rng.normal(size=(32, 4)).astype(np.float32), device=CPU)
    from keystone_tpu_torch.nodes.learning import LinearMapEstimator

    labels = Dataset(rng.normal(size=(32, 2)).astype(np.float32),
                     device=CPU)
    with profile_execution():
        p = Pipeline.gather([
            Transformer.from_function(lambda x: x * 2.0),
            Transformer.from_function(lambda x: x + 1.0),
        ])
        p(data).get()
        fitted = Transformer.from_function(lambda x: x).to_pipeline(
        ).and_then(LinearMapEstimator(0.1), data, labels)
        fitted(data).get()
        fitted(data).get()
    reg = registry()
    assert reg.counter("executor.node_forces").value > 0
    assert reg.counter("executor.memo_hits").value > 0
    assert reg.counter("executor.prefix_saves").value > 0


def test_untraced_runs_count_no_node_forces():
    """Without a tracer or a profiler nothing is instrumented: the hot
    path pays no wrapper (JAX's `observing` guard)."""
    data = Dataset(np.ones((8, 4), np.float32), device=CPU)
    _Cheap()(data).get()
    assert registry().counter("executor.node_forces").value == 0
    assert registry().counter("dispatch.programs_executed").value > 0


def test_scheduler_counts_and_span():
    from keystone_tpu_torch.nodes.util.basic import VectorCombiner

    branches = [Transformer.from_function((lambda k: lambda x: x * k)(i + 1),
                                          name=f"s{i}") for i in range(4)]
    with dispatch_override(True, workers=4), trace_run() as tr:
        (Pipeline.gather(branches) >> VectorCombiner())(
            Dataset(np.ones((8, 4), np.float32), device=CPU)).get()
    reg = registry()
    assert reg.counter("dispatch.scheduler_runs").value == 1
    assert reg.counter("dispatch.scheduled_tasks").value >= 4
    sched = [s for s in tr.spans if s.name == "dispatch.schedule"]
    assert len(sched) == 1 and sched[0].cat == "phase"
    # the workers' forces sit on their own lanes
    assert len({s.tid for s in tr.spans if s.cat == "node"}) > 1


def test_megafusion_counts_live_in_the_registry():
    inner = FusedBatchTransformer([NormalizeRows()], microbatch=512)
    mega = MegafusedBatchTransformer([inner], microbatch=512)
    with trace_run() as tr:
        mega.batch_fn()(torch.rand((1100, 7)) + 0.1)
    reg = registry()
    assert reg.counter("megafusion.programs").value == 1
    assert reg.counter("megafusion.scan_trips").value == 3
    assert reg.counter("megafusion.graph_captures").value == 0
    (prog,) = [s for s in tr.spans if s.name == "megafused_program"]
    assert prog.args["scan_trips"] == 3


# ---- timing: a tracer injects no sync, a profiler does ---------------------------


def test_tracing_adds_no_synchronizing_call(monkeypatch):
    """The synchronizing calls a run makes, counted by a stub on the
    CPU: equal traced and untraced; a profiler adds one a node force."""
    syncs = []
    monkeypatch.setattr(instrument, "sync_value",
                        lambda value: syncs.append(value))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append("cuda"))

    def run():
        rng = np.random.default_rng(1)
        X = Dataset(rng.normal(size=(40, 6)).astype(np.float32), device=CPU)
        y = Dataset(rng.integers(0, 3, size=40).astype(np.int32),
                    device=CPU)
        labels = ClassLabelIndicatorsFromInt(3)(y).get()
        p = Transformer.from_function(lambda x: x * 2.0).to_pipeline(
        ).and_then(BlockLeastSquaresEstimator(4, 2, 0.1), X, labels)
        return p(X).get().numpy()

    plain = run()
    untraced = len(syncs)
    PipelineEnv.reset()
    with trace_run():
        traced = run()
    assert len(syncs) == untraced
    np.testing.assert_array_equal(plain, traced)
    PipelineEnv.reset()
    with profile_execution():
        run()
    assert len(syncs) > untraced


# ---- compile accounting ------------------------------------------------------------


def test_host_library_builds_and_loads_are_counted(tmp_path, monkeypatch):
    """A library built by `_build` is a cold compile; a load of one built
    earlier is a cache hit (each with a ``compile`` span)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    with trace_run() as tr:
        _build.load_host("keystone_io")
    snap = telemetry.compiles_snapshot()
    assert snap["programs_compiled"] == 1 and snap["compile_cache_hits"] == 0
    assert snap["cold_compile_secs"] > 0
    monkeypatch.setattr(_build, "_loaded", {})
    _build.load_host("keystone_io")
    snap = telemetry.compiles_snapshot()
    assert snap["programs_compiled"] == 1 and snap["compile_cache_hits"] == 1
    (sp,) = [s for s in tr.spans if s.cat == "compile"]
    assert sp.args["cold"] is True and sp.args["kind"] == "host"
    assert sp.args["target"] == "keystone_io"
    line = telemetry.compile_summary(to_chrome_trace(tr))
    assert line.startswith("programs compiled: 1 cold")


def test_a_failed_build_raises_with_its_log(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(_build.HOST_SOURCES, "broken", (str(src), ()))
    with pytest.raises(RuntimeError, match="host build failed"):
        _build.build_host(["broken"])
    assert telemetry.compiles_snapshot()["programs_compiled"] == 0


# ---- parity with the JAX package ---------------------------------------------------


def _record(tracer_cls, ops):
    """Feed one recorded span sequence to a tracer."""
    t = tracer_cls()
    stack = []
    for op in ops:
        if op[0] == "start":
            stack.append(t.start(op[1], op[2], **op[3]))
        elif op[0] == "end":
            t.end(stack.pop(), error=op[1])
        else:
            t.record_complete(op[1], op[2], t.now(), 0.001, **op[3])
    return t


SPAN_OPS = [
    ("start", "run", "pipeline", {}),
    ("start", "optimize", "phase", {"batches": 4}),
    ("end", False),
    ("start", "force A", "node", {"vertex": 3}),
    ("start", "bcd_epoch", "step", {"iter": 0, "blocks": 2}),
    ("end", False),
    ("complete", "force streamed", "node", {"streamed": True}),
    ("start", "force B", "node", {"vertex": 4}),
    ("end", True),
    ("end", False),
    ("end", False),
]


def _comparable(trace):
    events = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                        "tid")}
              for e in trace["traceEvents"] if e.get("ph") != "M"]
    return events, trace["displayTimeUnit"]


def test_one_span_sequence_gives_jax_s_chrome_trace():
    jt = _record(jax_telemetry.Tracer, SPAN_OPS)
    pt = _record(telemetry.Tracer, SPAN_OPS)
    assert _comparable(to_chrome_trace(pt)) == _comparable(
        jax_telemetry.to_chrome_trace(jt))


@pytest.fixture(scope="module")
def jax_trace_path(tmp_path_factory):
    """A trace the JAX package wrote of a small traced run with chunk,
    step and node spans."""
    path = str(tmp_path_factory.mktemp("jax_trace") / "trace.json")
    from keystone_tpu import Dataset as JD, Transformer as JT

    with use_mesh(make_mesh(jax.devices()[:1])):
        with jax_telemetry.trace_run(path):
            with jax_telemetry.span("bcd_epoch", cat="step", iter=0):
                JT.from_function(lambda x: x * 2.0, name="double")(
                    JD.from_numpy(np.ones((8, 4), np.float32))).get()
    JaxPipelineEnv.reset()
    return path


def test_a_jax_trace_summarizes_the_same_through_both_clis(jax_trace_path,
                                                           capsys):
    """Equal text, the reconciliation sections included."""
    assert jax_cli([jax_trace_path]) == 0
    want = capsys.readouterr().out
    assert port_cli([jax_trace_path]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "top node forces by self-time" in got and "static vs" in got
    assert jax_cli(["--flight", jax_trace_path]) == 0
    want = capsys.readouterr().out
    assert port_cli(["--flight", jax_trace_path]) == 0
    assert capsys.readouterr().out == want


def test_a_port_trace_summarizes_the_same_through_both_clis(tmp_path,
                                                            capsys):
    path = _run_traced_pipeline(tmp_path)
    assert port_cli([path]) == 0
    got = capsys.readouterr().out
    assert jax_cli([path]) == 0
    want = capsys.readouterr().out
    assert got == want


def test_histogram_quantiles_equal_jax_s():
    rng = np.random.default_rng(3)
    obs = rng.exponential(size=3000).tolist()
    a = telemetry.histogram("parity.h")
    b = jax_telemetry.Histogram("parity.h")
    for v in obs:
        a.observe(v)
        b.observe(v)
    assert a.snapshot() == b.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert a.percentile(q) == b.percentile(q)


@pytest.fixture(scope="module")
def rpc_traces():
    """A small RandomPatchCifar fit and test apply traced in both
    packages, the port on JAX's filters and whitener."""
    cfg = dict(num_filters=16, block_size=64, microbatch=32,
               sample_patches=5000)
    n_train, n_test = 300, 100
    JaxPipelineEnv.reset()
    with use_mesh(make_mesh(jax.devices()[:1])):
        jtrain, jtest = jax_synthetic(n_train, n_test, noise=1.2,
                                      confusion=0.6)
        config = jax_rpc.RandomPatchCifarConfig(**cfg)
        jax_telemetry.registry().reset()
        jax_telemetry.ledger.clear_session()
        with jax_telemetry.trace_run() as jtr:
            jpred = np.asarray(jax_rpc.build_pipeline(jtrain, config)(
                jtest.data).get().array)[:n_test]
        jtrace = jax_telemetry.to_chrome_trace(jtr)
        filters, whitener = jax_rpc.learn_filters(jtrain.data, config)
    JaxPipelineEnv.reset()
    train, test = synthetic_cifar(n_train, n_test, noise=1.2,
                                  confusion=0.6, device="cpu")
    carried = (convert.to_tensor(np.asarray(filters), "cpu"),
               convert.whitener(whitener.whitener, whitener.means, "cpu"))
    real = rpc.learn_filters
    rpc.learn_filters = lambda data, config: carried
    try:
        PipelineEnv.reset()
        registry().reset()
        telemetry.ledger.clear_session()
        with trace_run() as ptr:
            ppred = rpc.build_pipeline(
                train, rpc.RandomPatchCifarConfig(**cfg))(
                    test.data).get().numpy()
        ptrace = to_chrome_trace(ptr)
    finally:
        rpc.learn_filters = real
        PipelineEnv.reset()
    return jtrace, ptrace, jpred, ppred


def _node_labels(trace):
    return {e["name"] for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "node"}


def _decision_keys(trace, kinds):
    return {telemetry.ledger.decision_key(d)
            for d in trace["keystone"].get("decisions", [])
            if d["kind"] in kinds}


def test_random_patch_cifar_traces_like_jax(rpc_traces):
    jtrace, ptrace, jpred, ppred = rpc_traces
    np.testing.assert_array_equal(ppred, jpred)
    assert {"force Cache[Cacher[features]]",
            "force Cache[DelegatingOperator]"} <= _node_labels(jtrace)
    assert _node_labels(ptrace) == _node_labels(jtrace)
    fusion = ("fusion", "megafusion")
    assert _decision_keys(ptrace, fusion) == _decision_keys(jtrace, fusion)
    assert _decision_keys(jtrace, ("cache",)) == {
        ("cache", "Cacher[features];DelegatingOperator")}
    assert _decision_keys(ptrace, ("cache",)) == \
        _decision_keys(jtrace, ("cache",))

    def programs(trace):
        return trace["keystone"]["metrics"]["counters"][
            "dispatch.programs_executed"]["value"]

    assert programs(ptrace) == programs(jtrace) == 8
    cats = {e.get("cat") for e in ptrace["traceEvents"] if e.get("ph") == "X"}
    assert {"pipeline", "phase", "node", "step"} <= cats
