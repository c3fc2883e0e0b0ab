"""The port's precision planner against the JAX package's, on the CPU.

`keystone_tpu_torch/analysis/precision.py` and
`workflow/optimizer.py::PrecisionPlannerRule` against
`keystone_tpu/analysis/precision.py` and JAX's rule: every tolerance
declaration, the policies, trails, menus and saved bytes on the seven
``analyzable()`` examples, the KP701–KP703 lints on the vertices
`tests/test_precision.py:221-363` checks, the casts a tagged fused
program runs, and planner-on outputs against the f32 reference.

JAX runs on a one-device mesh. Tolerances, each with its cause:

- Priced boundary totals may differ by the one stated width difference
  of `tests/test_torch_analysis_tiers.py`: ``MaxClassifier``'s output is
  int32 in JAX and int64 in torch (1,024 bytes at the examples' nominal
  count). Policies, tolerances, menus, trails and saved bytes are equal.
- bf16 storage: outputs within JAX's band, ``DEFAULT_BAND_RTOL`` 2e-2
  and ``DEFAULT_BAND_ATOL`` 5e-2 (two bf16 roundings); argmax outputs
  agree on at least 95% of rows, JAX's own bound.
"""

import ast
import importlib
import pathlib

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.analysis import as_source_spec as jax_source_spec
from keystone_tpu.analysis import precision as jp
from keystone_tpu.analysis.examples import EXAMPLES as JAX_EXAMPLES
from keystone_tpu.analysis.examples import build_example as jax_build
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JaxBLS,
)
from keystone_tpu.nodes.stats import LinearRectifier as JaxRectifier
from keystone_tpu.nodes.stats import RandomSignNode as JaxSign
from keystone_tpu.nodes.stats.normalization import (
    NormalizeRows as JaxNormalize,
    SignedHellingerMapper as JaxHellinger,
)
from keystone_tpu.nodes.util import Cacher as JaxCacher
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util import MaxClassifier as JaxMax
from keystone_tpu.nodes.util.fusion import (
    FusedBatchTransformer as JaxFused,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.workflow.env import PipelineEnv as JaxEnv
from keystone_tpu.workflow.env import config_override as jax_config
from keystone_tpu_torch.analysis import as_source_spec, spec_pass
from keystone_tpu_torch.analysis import precision as tp
from keystone_tpu_torch.analysis.diagnostics import Severity
from keystone_tpu_torch.analysis.examples import build_example
from keystone_tpu_torch.analysis.specs import DataSpec
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning.block_ls import (
    BlockLeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.stats.normalization import (
    NormalizeRows,
    SignedHellingerMapper,
)
from keystone_tpu_torch.nodes.stats.random_features import (
    LinearRectifier,
    RandomSignNode,
)
from keystone_tpu_torch.nodes.util.basic import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer
from keystone_tpu_torch.telemetry import ledger
from keystone_tpu_torch.workflow.env import PipelineEnv, config_override
from keystone_tpu_torch.workflow.fusion_rule import FusedChainOperator
from keystone_tpu_torch.workflow.optimizer import DefaultOptimizer

REPO = pathlib.Path(__file__).resolve().parents[1]
#: MaxClassifier's int32 (JAX) against int64 (torch) boundary, bytes
INT_WIDTH_BYTES = 4 * 256


def _declarations():
    """(module, class, attribute, value) of every precision declaration
    in the JAX package, read from its sources."""
    out = []
    for path in sorted((REPO / "keystone_tpu").rglob("*.py")):
        tree = ast.parse(path.read_text())
        module = ".".join(path.relative_to(REPO).with_suffix("").parts)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                        and isinstance(item.targets[0], ast.Name) \
                        and item.targets[0].id in ("precision_tolerance",
                                                   "precision_passthrough") \
                        and isinstance(item.value, ast.Constant) \
                        and item.value.value not in (None, False):
                    out.append((module, node.name, item.targets[0].id,
                                item.value.value))
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "precision_tolerance":
                    out.append((module, node.name, "precision_tolerance",
                                "property"))
    return out


DECLARATIONS = _declarations()


@pytest.fixture
def one_device_mesh():
    with use_mesh(make_mesh(jax.devices()[:1])) as mesh:
        yield mesh


def test_the_jax_package_declares_what_the_port_mirrors():
    assert len(DECLARATIONS) >= 40
    assert {d[3] for d in DECLARATIONS} >= {"tolerant", "exact", True,
                                            "property"}


@pytest.mark.parametrize("module,cls,attr,value", DECLARATIONS,
                         ids=[f"{d[1]}.{d[2]}" for d in DECLARATIONS])
def test_every_declaration_has_its_port_twin(module, cls, attr, value):
    """Each class declaring a precision hook in JAX declares the same in
    its port twin (same module path, same class name); a property is a
    property in both."""
    jax_cls = getattr(importlib.import_module(module), cls)
    port_cls = getattr(importlib.import_module(
        module.replace("keystone_tpu.", "keystone_tpu_torch.", 1)), cls)
    assert attr in vars(port_cls), (cls, attr)
    if value == "property":
        assert isinstance(vars(port_cls)[attr], property)
        assert isinstance(vars(jax_cls)[attr], property)
    else:
        assert vars(port_cls)[attr] == vars(jax_cls)[attr] == value


def _both(name):
    jpl, js = jax_build(name)
    tpl, ts = build_example(name, device="cpu")
    jspecs, _ = jax_spec_pass(jpl.graph, {jpl.source: jax_source_spec(js)})
    tspecs, _ = spec_pass(tpl.graph, {tpl.source: as_source_spec(ts)})
    return (jpl.graph, jspecs), (tpl.graph, tspecs)


def _ids(d):
    return {getattr(v, "id", v): x for v, x in d.items()}


def _vertex(graph, vid_id):
    return next(v for v in graph.operators if v.id == vid_id)


@pytest.mark.parametrize("name", list(JAX_EXAMPLES))
def test_plan_precision_matches_jax(name, one_device_mesh):
    (jg, jspecs), (tg, tspecs) = _both(name)
    a = jp.plan_precision(jg, jspecs)
    b = tp.plan_precision(tg, tspecs)
    assert (a is None) == (b is None)
    if a is None:
        return
    assert _ids(a.policies) == _ids(b.policies)
    assert _ids(a.tolerances) == _ids(b.tolerances)
    assert a.savings_bytes == b.savings_bytes
    assert a.improved == b.improved
    assert abs(a.default_cost_bytes - b.default_cost_bytes) \
        in (0, INT_WIDTH_BYTES)
    ma = jp._PrecisionModel(jg, jspecs, tolerances=a.tolerances)
    mb = tp._PrecisionModel(tg, tspecs, tolerances=b.tolerances)
    assert _ids(ma.menus) == _ids(mb.menus)
    for vid in ma.menus:
        tvid = _vertex(tg, vid.id)
        for pol in ma.menus[vid]:
            assert jp.policy_nbytes(jspecs[vid], pol) == \
                tp.policy_nbytes(tspecs[tvid], pol)


@pytest.mark.parametrize("name", list(JAX_EXAMPLES))
def test_plan_stage_precision_matches_jax(name, one_device_mesh):
    """The fused programs' trails, saved bytes and priced menus."""
    from keystone_tpu.workflow.fusion_rule import (
        FusedChainOperator as JaxChain,
    )

    (jg, jspecs), (tg, tspecs) = _both(name)
    for vid in jg.operators:
        op = jg.get_operator(vid)
        if not isinstance(op, (JaxChain, JaxFused)):
            continue
        tvid = _vertex(tg, vid.id)
        assert jp.plan_stage_precision(jg, vid, op, jspecs) == \
            tp.plan_stage_precision(tg, tvid, tg.get_operator(tvid), tspecs)


def test_plan_precision_strictly_wins_on_two_examples(one_device_mesh):
    strict = 0
    for name in JAX_EXAMPLES:
        _, (tg, tspecs) = _both(name)
        plan = tp.plan_precision(tg, tspecs)
        if plan is None:
            continue
        assert plan.planned_cost_bytes <= plan.default_cost_bytes
        strict += plan.improved
        gate = [d for d in tp.precision_pass(tg, tspecs, plan)
                if d.severity >= Severity.WARNING]
        assert gate == []
    assert strict >= 2


def test_policy_nbytes_is_dtype_aware():
    from keystone_tpu_torch.analysis.specs import shape_struct

    f = DataSpec(element=shape_struct((8,), torch.float32), count=4)
    i = DataSpec(element=shape_struct((8,), torch.int32), count=4)
    assert tp.policy_nbytes(f, tp.POLICY_F32) == 128
    assert tp.policy_nbytes(f, tp.POLICY_BF16) == 64
    assert tp.policy_nbytes(i, tp.POLICY_BF16) == 128
    for saved, legal in (([2000, 2000], [True, True]),
                         ([4000, 97], [True, True]),
                         ([9000, 1, 9000], [True, False, True])):
        assert tp._plan_path(saved, legal) == jp._plan_path(saved, legal)
    assert tp._plan_path([2000, 2000], [True, True]) == [False, False]
    assert tp._plan_path([4000, 97], [True, True]) == [True, True]


# -------------------------------------------------------------- the lints


def _kp(diags, rule):
    return [(d.vertex.id, int(d.severity)) for d in diags if d.rule == rule]


def test_kp701_fires_on_the_vertex_jax_flags(one_device_mesh):
    """A hand-written bf16, and a compute-only, policy on an exact
    boundary of RandomPatchCifar; the compute-only policy on a tolerant
    stage feeding an exact one passes (`test_precision.py:221-241,
    363-398`)."""
    (jg, jspecs), (tg, tspecs) = _both("RandomPatchCifar")
    exact = sorted(v.id for v in jg.operators
                   if getattr(jg.get_operator(v), "precision_tolerance",
                              None) == jp.EXACT
                   and type(jspecs.get(v)).__name__ == "DataSpec")
    assert exact
    vec = next(v.id for v in jg.operators
               if type(jg.get_operator(v)).__name__ == "ImageVectorizer")
    for vid, pol in ((exact[0], "bf16"), (exact[0], "f32_bf16"),
                     (vec, "f32_bf16")):
        ja, ta = _vertex(jg, vid), _vertex(tg, vid)
        want = jp.precision_pass(jg, jspecs, jp.PrecisionPlan(
            {ja: pol}, {ja: "f32"}, 0, 0))
        got = tp.precision_pass(tg, tspecs, tp.PrecisionPlan(
            {ta: pol}, {ta: "f32"}, 0, 0))
        assert _kp(got, "KP701") == _kp(want, "KP701")
    assert _kp(got, "KP701") == []  # the vectorizer case


def test_kp702_fires_on_cast_thrash(one_device_mesh):
    jpipe = (JaxHellinger().to_pipeline() >> JaxNormalize()
             >> JaxRectifier(0.0))
    tpipe = (SignedHellingerMapper().to_pipeline() >> NormalizeRows()
             >> LinearRectifier(0.0))
    from keystone_tpu.analysis import SpecDataset as JaxSpecDataset
    from keystone_tpu_torch.analysis import SpecDataset

    jspecs, _ = jax_spec_pass(jpipe.graph, {jpipe.source: jax_source_spec(
        JaxSpecDataset((8,), np.float32, count=4).spec)})
    tspecs, _ = spec_pass(tpipe.graph, {tpipe.source: as_source_spec(
        SpecDataset((8,), np.float32, count=4).spec)})
    first = min(v.id for v in jpipe.graph.operators)
    ja, ta = _vertex(jpipe.graph, first), _vertex(tpipe.graph, first)
    want = jp.precision_pass(jpipe.graph, jspecs, jp.PrecisionPlan(
        {ja: "bf16"}, {ja: "f32"}, 0, 0))
    got = tp.precision_pass(tpipe.graph, tspecs, tp.PrecisionPlan(
        {ta: "bf16"}, {ta: "f32"}, 0, 0))
    assert _kp(got, "KP702") == _kp(want, "KP702") == [
        (first, int(Severity.WARNING))]


def test_kp703_reprices_the_vertices_jax_reprices(one_device_mesh):
    (jg, jspecs), (tg, tspecs) = _both("RandomPatchCifar")
    ja, jb, jd = jp.reprice_memory(jg, jspecs, jp.plan_precision(jg, jspecs))
    ta, tb, td = tp.reprice_memory(tg, tspecs, tp.plan_precision(tg, tspecs))
    assert sorted(_kp(td, "KP703")) == sorted(_kp(jd, "KP703"))
    assert _kp(td, "KP703")
    assert tb.peak_bytes < ta.peak_bytes
    assert {v.id: r for v, r in tb.resident.items()} == \
        {v.id: r for v, r in jb.resident.items()}


def test_validate_graph_lints_a_given_plan(one_device_mesh):
    from keystone_tpu_torch.analysis import validate_graph

    _, (tg, tspecs) = _both("RandomPatchCifar")
    pipe, spec = build_example("RandomPatchCifar", device="cpu")
    plan = tp.plan_precision(tg, tspecs)
    report = validate_graph(pipe.graph, {pipe.source: spec},
                            precision=plan, hbm_budget_bytes=1 << 20)
    rules = {d.rule for d in report.diagnostics}
    assert "KP703" in rules and "KP701" not in rules
    assert "KP600" in rules and "KP202" not in rules  # KP600's place


# ------------------------------------------------------------ enforcement


def test_casts_run_between_stages_and_output_dtype_is_restored():
    """A tagged fused transformer casts each stage's output to its
    planned dtype (the stages after a bf16 boundary see bf16) and
    restores float32 at the end; within JAX's band of the untagged
    chain, and of JAX's tagged program."""
    seen = []

    class Probe(LinearRectifier):
        def batch_fn(self):
            fn = super().batch_fn()

            def run(x):
                seen.append(x.dtype)
                return fn(x)
            return run

    stages = [RandomSignNode(64, device="cpu"), SignedHellingerMapper(),
              NormalizeRows(), Probe(0.0)]
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    # no chain kernel: each stage runs on its own, so the casts show
    tagged = FusedBatchTransformer(stages).tagged_copy(
        planned_precision=(None, "bfloat16", "bfloat16", "float32"),
        planned_kernel=None)
    out = tagged.apply_batch(Dataset(x, device="cpu")).array
    assert seen == [torch.bfloat16] and out.dtype == torch.float32
    ref = FusedBatchTransformer(stages).tagged_copy(
        planned_kernel=None).apply_batch(Dataset(x, device="cpu")).array
    assert seen[-1] == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(),
                               rtol=tp.DEFAULT_BAND_RTOL,
                               atol=tp.DEFAULT_BAND_ATOL)
    jt = JaxFused([JaxSign(64), JaxHellinger(), JaxNormalize(),
                   JaxRectifier(0.0)])
    jt.planned_precision = (None, "bfloat16", "bfloat16", "float32")
    jout = np.asarray(jt.apply_batch(JaxDataset.from_numpy(x)).numpy())
    np.testing.assert_allclose(out.numpy(), jout, rtol=tp.DEFAULT_BAND_RTOL,
                               atol=tp.DEFAULT_BAND_ATOL)


def test_a_tagged_copy_builds_its_own_program():
    """`tagged_copy` gives a fused program its own launch plans and
    graphs, and a chain operator its own build, which carries the tags."""
    ft = FusedBatchTransformer([RandomSignNode(8, device="cpu"),
                                LinearRectifier(0.0)])
    copy = ft.tagged_copy(planned_precision=("bfloat16", "float32"))
    assert copy._graphs is not ft._graphs and ft.planned_precision is None
    chain = FusedChainOperator([RandomSignNode(8, device="cpu"),
                                LinearRectifier(0.0)])
    built = chain.materialize([])
    tagged = chain.tagged_copy(planned_precision=("bfloat16", "float32"),
                               planned_matmul_precision="bfloat16")
    tbuilt = tagged.materialize([])
    assert tbuilt is not built
    assert tbuilt.planned_precision == ("bfloat16", "float32")
    assert tbuilt.planned_matmul_precision == "bfloat16"
    assert built.planned_precision is None


def _data(n, dim=64, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int32))


def _port_run(n, optimizer=None, **overrides):
    X, y = _data(n)
    PipelineEnv.reset()
    try:
        if optimizer is not None:
            PipelineEnv.get().set_optimizer(optimizer)
        with config_override(**overrides):
            featurizer = (RandomSignNode(64, device="cpu").to_pipeline()
                          >> SignedHellingerMapper() >> NormalizeRows()
                          >> LinearRectifier(0.0) >> Cacher("feat"))
            data = Dataset(X, device="cpu")
            labels = ClassLabelIndicatorsFromInt(4)(
                Dataset(y, device="cpu"))
            applied = (featurizer.and_then(
                BlockLeastSquaresEstimator(32, num_iter=1, lam=1e-3),
                data, labels) >> MaxClassifier())(data)
            out = applied.get().array.numpy()
            return out, applied.executor.optimized_graph
    finally:
        PipelineEnv.reset()


def _jax_run(n, **overrides):
    from keystone_tpu.workflow.optimizer import (
        DefaultOptimizer as JaxOptimizer,
    )

    X, y = _data(n)
    JaxEnv.reset()
    try:
        JaxEnv.get().set_optimizer(JaxOptimizer(
            fuse=False, sharding_planner=False, precision_planner=False))
        with jax_config(precision_planner=False, **overrides):
            featurizer = (JaxSign(64).to_pipeline() >> JaxHellinger()
                          >> JaxNormalize() >> JaxRectifier(0.0)
                          >> JaxCacher("feat"))
            data = JaxDataset.from_numpy(X)
            labels = JaxIndicators(4)(JaxDataset.from_numpy(y))
            applied = (featurizer.and_then(
                JaxBLS(32, num_iter=1, lam=1e-3), data, labels)
                >> JaxMax())(data)
            return np.asarray(applied.get().numpy())
    finally:
        JaxEnv.reset()


def _tagged(graph):
    return [graph.get_operator(v) for v in graph.operators
            if getattr(graph.get_operator(v), "planned_precision", None)
            is not None]


@pytest.mark.parametrize("n", [64, 43], ids=["multiple", "ragged"])
def test_policy_on_outputs_in_band(n, one_device_mesh):
    """Planner-on predictions (the trail enforced, not a no-op) against
    the serial unfused f32 runs of both packages, at a multiple and a
    ragged count: argmax agreement of at least 95% (JAX's bound)."""
    planned, g_on = _port_run(n, precision_planner=True,
                              precision_min_savings_bytes=0,
                              unified_planner=False)
    assert _tagged(g_on), f"no policy enforced at count {n}"
    serial, _ = _port_run(n, DefaultOptimizer(
        fuse=False, sharding_planner=False, precision_planner=False))
    jax_serial = _jax_run(n)
    assert planned.shape == serial.shape == jax_serial.shape
    assert np.mean(planned == serial) >= 0.95
    assert np.mean(planned == jax_serial) >= 0.95


def test_enforced_trail_keeps_exact_boundaries_and_is_recorded():
    """Boundaries next to an exact stage stay f32, each bf16 run ends in
    an up-cast, the output is restored, and the ledger holds a
    ``precision`` record of the rule (`test_precision.py:592-623`)."""
    from keystone_tpu_torch.analysis.precision import stage_tolerance
    from keystone_tpu_torch.nodes.util.fusion import _peephole

    mark = ledger.session_mark()
    _, g_on = _port_run(64, precision_planner=True,
                        precision_min_savings_bytes=0,
                        unified_planner=False)
    tagged = _tagged(g_on)
    assert tagged
    for op in tagged:
        specs_ = getattr(op, "stage_specs", None)
        stages = _peephole(list(specs_ if specs_ is not None
                                else op.stages))
        storage = op.planned_precision
        vid = next(v for v in g_on.operators if g_on.get_operator(v) is op)
        tols = [stage_tolerance(s, g_on, vid) for s in stages]
        for i, st in enumerate(storage[:-1]):
            if st == "bfloat16":
                assert tols[i] == tols[i + 1] == tp.TOLERANT
                assert storage[i + 1] is not None
        assert storage[-1] in (None, "float32")
    records = [r for r in ledger.session_since(mark)
               if r["kind"] == "precision"]
    assert records and records[0]["rule"] == "PrecisionPlannerRule"
    assert records[0]["alternatives"][0]["entry"] == "f32_reference"


def test_kill_switches_leave_the_plan_untagged():
    """``precision_planner`` off by config and by constructor give the
    same untagged plan; on, it tags (so the check is not vacuous)."""
    _, g_off = _port_run(64, precision_planner=False, unified_planner=False)
    _, g_ctor = _port_run(64, DefaultOptimizer(precision_planner=False),
                          unified_planner=False)
    _, g_on = _port_run(64, precision_planner=True, unified_planner=False,
                        precision_min_savings_bytes=0)

    def shape(g):
        return [(v.id, type(g.get_operator(v)).__name__,
                 tuple(getattr(d, "id", d) for d in g.get_dependencies(v)),
                 getattr(g.get_operator(v), "planned_precision", None))
                for v in sorted(g.operators, key=lambda v: v.id)]

    assert shape(g_off) == shape(g_ctor)
    assert all(t[3] is None for t in shape(g_off))
    assert any(t[3] is not None for t in shape(g_on))
    assert [t[:3] for t in shape(g_on)] == [t[:3] for t in shape(g_off)]
