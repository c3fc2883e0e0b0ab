"""The port's unified plan optimizer against the JAX package's, on the
CPU.

`keystone_tpu_torch/analysis/plan_ir.py::plan_unified` and
`workflow/optimizer.py::UnifiedPlannerRule` against
`keystone_tpu/analysis/plan_ir.py` and JAX's rule
(`tests/test_unified_planner.py`): the chosen assignment (trails, chunk,
caches, spills, kernel runs), ``improved``, ``changed_kinds()`` and both
predicted seconds on the seven ``analyzable()`` examples and on JAX's
``_predictor`` graph; the sequential composition among the scored
candidates; the kill switches; the constructor's opt-out; the ledger
records; the kernel decision against `plan_chain_kernel`'s tag; and the
planner-on `DefaultOptimizer` plan against JAX's planner-on plan.

Both sides price with one pinned machine, JAX's CPU rates (50 GFLOP/s,
20 GB/s), the port's CPU analytic rates too, and a chunk of 256 rows;
JAX runs on a one-device mesh. Stated tolerance: predicted seconds
within ``SECONDS_RTOL`` (5%): the port's stage FLOPs are aten ops priced
on meta tensors, JAX's the jaxpr's primitives, within 5% of each other
(`tests/test_torch_analysis_tiers.py`).
"""

import numpy as np
import pytest

import jax
from keystone_tpu.analysis import as_source_spec as jax_source_spec
from keystone_tpu.analysis.examples import EXAMPLES as JAX_EXAMPLES
from keystone_tpu.analysis.examples import build_example as jax_build
from keystone_tpu.analysis.plan_ir import plan_unified as jax_plan_unified
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.analysis.roofline import Machine as JaxMachine
from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBLS,
)
from keystone_tpu.nodes.stats import LinearRectifier as JaxRectifier
from keystone_tpu.nodes.stats import PaddedFFT as JaxFFT
from keystone_tpu.nodes.stats import RandomSignNode as JaxSign
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util import MaxClassifier as JaxMax
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.workflow.env import PipelineEnv as JaxEnv
from keystone_tpu.workflow.env import config_override as jax_config
from keystone_tpu_torch.analysis import Machine, as_source_spec, spec_pass
from keystone_tpu_torch.analysis.examples import build_example
from keystone_tpu_torch.analysis.plan_ir import (
    CHUNK_LADDER,
    machine_from_weights,
    plan_unified,
)
from keystone_tpu_torch.analysis.precision import precision_pass
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.learning.block_ls import (
    BlockLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats.random_features import (
    LinearRectifier,
    PaddedFFT,
    RandomSignNode,
)
from keystone_tpu_torch.nodes.util.basic import (
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    plan_chain_kernel,
    stage_fuse,
)
from keystone_tpu_torch.telemetry import ledger
from keystone_tpu_torch.workflow.autocache import CacheMarker
from keystone_tpu_torch.workflow.env import (
    PipelineEnv,
    config_override,
    planned_chunk_size,
    resolved_chunk_size,
    set_planned_chunk_size,
)
from keystone_tpu_torch.workflow.fusion_rule import FusedChainOperator
from keystone_tpu_torch.workflow.optimizer import (
    _UNIFIED_OWNED,
    DefaultOptimizer,
    unified_enforced,
)
from keystone_tpu_torch.workflow.pipeline import Transformer

CHUNK = 256
MACHINE = (5e10, 2e10)
SECONDS_RTOL = 0.05


@pytest.fixture(autouse=True)
def _one_device_and_chunk():
    with use_mesh(make_mesh(jax.devices()[:1])), \
            jax_config(chunk_size=CHUNK), config_override(chunk_size=CHUNK):
        yield
    set_planned_chunk_size(None)
    PipelineEnv.reset()


def _ids(assignment):
    """An assignment by vertex id, comparable across the packages."""
    return dict(
        trails={v.id: on for v, on in assignment.trails},
        policies={v.id: p for v, p in assignment.policies},
        chunk=assignment.chunk,
        caches=sorted(v.id for v in assignment.caches),
        spills=sorted(v.id for v in assignment.spills),
        kernels={v.id: on for v, on in assignment.kernels})


def _assert_same_plan(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert _ids(b.chosen) == _ids(a.chosen)
    assert _ids(b.sequential_assignment) == _ids(a.sequential_assignment)
    assert b.improved == a.improved
    assert b.changed_kinds() == a.changed_kinds()
    assert b.sequential_seconds == pytest.approx(a.sequential_seconds,
                                                 rel=SECONDS_RTOL)
    assert b.joint_seconds == pytest.approx(a.joint_seconds,
                                            rel=SECONDS_RTOL)
    assert {c["entry"] for c in b.scored_candidates} == \
        {c["entry"] for c in a.scored_candidates}
    assert {v.id: p for v, p in b.spill_predictions.items()}.keys() == \
        {v.id: p for v, p in a.spill_predictions.items()}.keys()


@pytest.mark.parametrize("name", list(JAX_EXAMPLES))
def test_plan_unified_matches_jax_on_the_examples(name):
    jpl, js = jax_build(name)
    tpl, ts = build_example(name, device="cpu")
    jspecs, _ = jax_spec_pass(jpl.graph, {jpl.source: jax_source_spec(js)})
    tspecs, _ = spec_pass(tpl.graph, {tpl.source: as_source_spec(ts)})
    a = jax_plan_unified(jpl.graph, jspecs, machine=JaxMachine(*MACHINE))
    b = plan_unified(tpl.graph, tspecs, machine=Machine(*MACHINE))
    _assert_same_plan(a, b)
    if b is not None and b.boundary_precision is not None:
        assert not [d for d in precision_pass(tpl.graph, tspecs,
                                              b.boundary_precision)
                    if d.rule == "KP701"]


def _data(n, dim=64, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int32))


def _port_predictor(data, labels_ds, dim=64, classes=4):
    featurizer = (RandomSignNode(dim, device="cpu").to_pipeline()
                  >> PaddedFFT() >> LinearRectifier(0.0))
    labels = ClassLabelIndicatorsFromInt(classes)(labels_ds)
    return featurizer.and_then(
        BlockLeastSquaresEstimator(32, num_iter=1, lam=1e-3),
        data, labels) >> MaxClassifier()


def _jax_predictor(data, labels_ds, dim=64, classes=4):
    featurizer = (JaxSign(dim).to_pipeline() >> JaxFFT()
                  >> JaxRectifier(0.0))
    labels = JaxIndicators(classes)(labels_ds)
    return featurizer.and_then(JaxBLS(32, num_iter=1, lam=1e-3), data,
                               labels) >> JaxMax()


def _applied(n, **cfg):
    X, y = _data(n)
    with config_override(unified_min_savings_seconds=0.0, **cfg):
        applied = _port_predictor(Dataset(X, device="cpu"),
                                  Dataset(y, device="cpu"))(
            Dataset(X, device="cpu"))
        applied.executor.optimized_graph  # optimized under this config
    return applied


def _jax_applied(n, **cfg):
    X, y = _data(n)
    with jax_config(unified_min_savings_seconds=0.0, **cfg):
        applied = _jax_predictor(JaxDataset.from_numpy(X),
                                 JaxDataset.from_numpy(y))(
            JaxDataset.from_numpy(X))
        applied.executor.optimized_graph
    return applied


@pytest.mark.parametrize("budget", [None, 32 << 10], ids=["free", "tight"])
@pytest.mark.parametrize("spill", [False, True], ids=["no_spill", "spill"])
def test_plan_unified_matches_jax_on_the_predictor(budget, spill):
    """JAX's ``_predictor`` graph (`tests/test_unified_planner.py:52-62`),
    as each executor holds it before optimizing, without and with a
    budget every device cache busts."""
    a_app, b_app = _jax_applied(4096), _applied(4096)
    jspecs, _ = jax_spec_pass(a_app.executor.graph, {})
    tspecs, _ = spec_pass(b_app.executor.graph, {})
    a = jax_plan_unified(a_app.executor.graph, jspecs,
                         machine=JaxMachine(*MACHINE),
                         hbm_budget_bytes=budget, allow_spill=spill,
                         include_boundary_policies=False)
    b = plan_unified(b_app.executor.graph, tspecs, machine=Machine(*MACHINE),
                     hbm_budget_bytes=budget, allow_spill=spill,
                     include_boundary_policies=False)
    _assert_same_plan(a, b)


def test_sequential_is_always_a_scored_candidate():
    pipe, spec = build_example("MnistRandomFFT", device="cpu")
    specs, _ = spec_pass(pipe.graph, {pipe.source: as_source_spec(spec)})
    plan = plan_unified(pipe.graph, specs, machine=Machine(*MACHINE))
    entries = {c["entry"]: c for c in plan.scored_candidates}
    assert entries["sequential"]["predicted_seconds"] == pytest.approx(
        plan.sequential_seconds)
    assert entries["joint_optimum"]["predicted_seconds"] == pytest.approx(
        plan.joint_seconds)
    assert plan.joint_seconds <= plan.sequential_seconds
    assert CHUNK_LADDER[0] == 32 and CHUNK_LADDER[-1] == 4096


def test_recalibrated_weights_change_the_machine():
    pipe, spec = build_example("MnistRandomFFT", device="cpu")
    specs, _ = spec_pass(pipe.graph, {pipe.source: as_source_spec(spec)})
    base = plan_unified(pipe.graph, specs, machine=Machine(*MACHINE))
    slow = (1.0 / 5.0e10, 10.0 / 2.0e10, 1e-11)  # resolve_weights' shape
    assert machine_from_weights(slow).peak_bw == pytest.approx(2.0e9)
    assert plan_unified(pipe.graph, specs, weights=slow
                        ).sequential_seconds > base.sequential_seconds


def _shape(g):
    return [(v.id, type(g.get_operator(v)).__name__,
             tuple(getattr(d, "id", d) for d in g.get_dependencies(v)),
             getattr(g.get_operator(v), "planned_precision", None),
             getattr(g.get_operator(v), "planned_by_unified", False))
            for v in sorted(g.operators, key=lambda v: v.id)]


@pytest.mark.parametrize("legacy", [
    {}, {"megafusion": False}, {"sharding_planner": False},
    {"precision_planner": False},
    {"megafusion": False, "sharding_planner": False,
     "precision_planner": False},
])
def test_kill_switch_matrix_leaves_the_plan_untouched(legacy):
    """``unified_planner`` off by config, with each other switch, gives
    the plan the constructor's opt-out builds: no cache marker, no
    unified tag, no planned chunk."""
    PipelineEnv.reset()
    g_off = _applied(256, unified_planner=False,
                     **legacy).executor.optimized_graph
    PipelineEnv.reset()
    PipelineEnv.get().set_optimizer(DefaultOptimizer(unified_planner=False))
    g_ctor = _applied(256, **legacy).executor.optimized_graph
    assert _shape(g_off) == _shape(g_ctor)
    assert not any(t[1] == "CacheMarker" or t[4] for t in _shape(g_off))
    assert planned_chunk_size() is None


def test_unified_on_enforces_and_the_switch_removes_it():
    PipelineEnv.reset()
    g_on = _applied(256).executor.optimized_graph
    PipelineEnv.reset()
    g_off = _applied(256, unified_planner=False).executor.optimized_graph
    assert [v for v in g_on.operators
            if isinstance(g_on.get_operator(v), CacheMarker)]
    assert not [v for v in g_off.operators
                if isinstance(g_off.get_operator(v), CacheMarker)]


def test_the_planner_on_plan_matches_jax():
    """The whole planner-on `DefaultOptimizer` plan, both packages'
    defaults, floor dropped: the same vertices, classes and
    dependencies, the same cache markers and planned chunk."""
    JaxEnv.reset()
    a = _jax_applied(256).executor.optimized_graph
    from keystone_tpu.workflow.env import planned_chunk_size as jax_planned

    a_chunk = jax_planned()
    PipelineEnv.reset()
    b = _applied(256).executor.optimized_graph
    JaxEnv.reset()

    def shape(g):
        return [(v.id, type(g.get_operator(v)).__name__,
                 tuple(getattr(d, "id", d) for d in g.get_dependencies(v)),
                 getattr(g.get_operator(v), "placement", None))
                for v in sorted(g.operators, key=lambda v: v.id)]

    assert shape(b) == shape(a)
    assert planned_chunk_size() == a_chunk


@pytest.mark.parametrize("count", [64, 43])
def test_unified_on_outputs_match_serial_unfused(count):
    """Planner-on predictions (enforcement live) equal the serial
    unfused run's at a multiple and a ragged count."""
    X, y = _data(count)

    def run(optimizer=None, **cfg):
        PipelineEnv.reset()
        if optimizer is not None:
            PipelineEnv.get().set_optimizer(optimizer)
        with config_override(unified_min_savings_seconds=0.0, **cfg):
            data = Dataset(X, device="cpu")
            return _port_predictor(data, Dataset(y, device="cpu"))(
                data).get().array.numpy()

    on = run()
    serial = run(DefaultOptimizer(fuse=False, unified_planner=False,
                                  precision_planner=False))
    assert np.mean(on == serial) >= 0.95


def test_no_win_is_a_strict_noop():
    X = np.arange(64, dtype=np.float32).reshape(16, 4)
    pipe = (Transformer.from_function(lambda x: x * 2.0).to_pipeline()
            >> Transformer.from_function(lambda x: x + 1.0))
    shapes = []
    for cfg in ({}, {"unified_planner": False}):
        PipelineEnv.reset()
        with config_override(unified_min_savings_seconds=0.0, **cfg):
            shapes.append(_shape(
                pipe(Dataset(X, device="cpu")).executor.optimized_graph))
    assert shapes[0] == shapes[1]
    assert planned_chunk_size() is None


def test_host_only_pipeline_clears_a_stale_chunk():
    set_planned_chunk_size(512)
    assert resolved_chunk_size() == 512
    pipe = Transformer.from_function(lambda x: x * 2.0).to_pipeline()
    pipe(HostDataset([np.ones((4,), np.float32)] * 3, device="cpu")).get()
    assert planned_chunk_size() is None
    assert resolved_chunk_size() == CHUNK


def test_constructor_optout_clears_a_stale_chunk():
    set_planned_chunk_size(2048)
    assert resolved_chunk_size() == 2048
    PipelineEnv.get().set_optimizer(DefaultOptimizer(unified_planner=False))
    pipe = Transformer.from_function(lambda x: x * 2.0).to_pipeline()
    pipe(Dataset(np.ones((8, 4), np.float32), device="cpu")).get()
    assert planned_chunk_size() is None
    assert resolved_chunk_size() == CHUNK


def test_planned_chunk_respects_the_switch():
    set_planned_chunk_size(512)
    assert resolved_chunk_size() == 512
    with config_override(unified_planner=False):
        assert planned_chunk_size() is None
        assert resolved_chunk_size() == CHUNK
    assert resolved_chunk_size() == 512


def test_ownership_survives_tagfree_enforcement():
    pipe = Transformer.from_function(lambda x: x * 2.0).to_pipeline()
    g = pipe(Dataset(np.ones((8, 4), np.float32),
                     device="cpu")).executor.optimized_graph
    assert not unified_enforced(g)
    _UNIFIED_OWNED.add(g)
    try:
        assert unified_enforced(g)
    finally:
        _UNIFIED_OWNED.discard(g)


def test_enforced_decisions_have_ledger_records():
    mark = ledger.session_mark()
    g = _applied(256).executor.optimized_graph
    decisions = [d for d in ledger.session_since(mark)
                 if d["rule"] == "UnifiedPlannerRule"]
    assert decisions
    assert {v.id for v in g.operators
            if isinstance(g.get_operator(v), CacheMarker)}
    for d in decisions:
        assert d["kind"] in ("precision", "chunk", "cache", "kernel",
                             "spill")
        assert d["predicted"]["seconds_saved"] > 0
        assert "sequential" in {a.get("entry") for a in d["alternatives"]}
    assert any(d["kind"] == "cache" and d["vertices"] for d in decisions)


def test_the_kernel_decision_is_the_self_tag():
    """Where the kernel axis takes a fused program's chain kernel, the
    slice it records is the one `plan_chain_kernel` tags the program
    with (LinearPixels, JAX's example where the kernel axis wins)."""
    pipe, spec = build_example("LinearPixels", device="cpu")
    specs, _ = spec_pass(pipe.graph, {pipe.source: as_source_spec(spec)})
    plan = plan_unified(pipe.graph, specs, machine=Machine(*MACHINE))
    assert "kernel" in plan.changed_kinds() and plan.kernel_choices
    for vid, cand in plan.kernel_choices.items():
        op = pipe.graph.get_operator(vid)
        assert isinstance(op, (FusedBatchTransformer, FusedChainOperator))
        stages = (op.fused if isinstance(op, FusedBatchTransformer)
                  else op.materialize([]).fused)
        tag = plan_chain_kernel(stage_fuse(s)[0] for s in stages)
        assert tag == tuple(cand["stage_slice"]) + (
            cand["lowerable"]["family"],)
        assert cand["feasible"][0]
