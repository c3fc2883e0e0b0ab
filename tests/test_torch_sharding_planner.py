"""The sharding planner (`keystone_tpu_torch/analysis/planner.py`), the
unified planner's placement axis and the CLI's ``--mesh-shape``, against
JAX's (`keystone_tpu/analysis/planner.py`, `tests/test_planner.py`).

The planner is spec arithmetic, so both packages plan the same graphs on
the same mesh shape in one process: JAX on a 2×4 slice of the conftest's
8-device CPU mesh, the port on the layout ``{"data": 2, "model": 4}``.
They agree on the family chosen for each stage, the default and planned
boundary bytes and ``improved``; `collective_cost` moves JAX's bytes for
every kind and shard count (the seconds are the port's card-to-card
rate). The enforcement over live ranks is in
`tests/test_torch_model_axis.py`.
"""

import json

import jax
import numpy as np
import pytest

from keystone_tpu.analysis import (
    SpecDataset as JaxSpecDataset,
    as_source_spec as jax_as_source_spec,
    plan_sharding as jax_plan_sharding,
)
from keystone_tpu.analysis.examples import EXAMPLES as JAX_EXAMPLES
from keystone_tpu.analysis.examples import build_example as jax_build
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JaxBCD
from keystone_tpu.nodes.stats import (
    CosineRandomFeatures as JaxCosine,
    RandomSignNode as JaxRandomSign,
)
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.workflow import Transformer as JaxTransformer

from keystone_tpu_torch.analysis import (
    SpecDataset,
    as_source_spec,
    plan_sharding,
)
from keystone_tpu_torch.analysis.examples import build_example
from keystone_tpu_torch.analysis.planner import (
    FAMILY_DATA,
    FAMILY_DATA_MODEL,
    FAMILY_MODEL,
    FAMILY_REPLICATED,
    _CostModel,
    family_of,
    realize_family,
)
from keystone_tpu_torch.analysis.propagate import spec_pass
from keystone_tpu_torch.analysis.sharding import sharding_pass
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning import cost_model
from keystone_tpu_torch.nodes.stats import CosineRandomFeatures, RandomSignNode
from keystone_tpu_torch.parallel import mesh as meshlib
from keystone_tpu_torch.workflow import Transformer
from keystone_tpu_torch.workflow.graph import NodeId

LAYOUT = {"data": 2, "model": 4}
EXAMPLES_2X4 = ("MnistRandomFFT", "LinearPixels", "RandomPatchCifar",
                "TimitPipeline")


def _jax_mesh():
    return jmesh.make_mesh(jax.devices()[:8], shape=(2, 4),
                           axis_names=(jmesh.DATA_AXIS, jmesh.MODEL_AXIS))


def _plans(name):
    mesh = _jax_mesh()
    with jmesh.use_mesh(mesh):
        jp, jsrc = jax_build(name)
        jspecs, _ = jax_spec_pass(jp.graph,
                                  {jp.source: jax_as_source_spec(jsrc)})
        jplan = jax_plan_sharding(jp.graph, jspecs, mesh=mesh)
    pp, psrc = build_example(name, device="cpu")
    pspecs, _ = spec_pass(pp.graph, {pp.source: as_source_spec(psrc)})
    return jplan, plan_sharding(pp.graph, pspecs, mesh=LAYOUT), pp, pspecs


def _families(plan):
    """(vertex kind, id, family) a vertex, in a package-neutral order."""
    return sorted((type(v).__name__, getattr(v, "id", -1), f)
                  for v, f in plan.families.items())


@pytest.mark.parametrize("name", sorted(JAX_EXAMPLES))
def test_plan_equals_jax_on_2x4(name):
    """Each example's chosen family per stage, the default and planned
    boundary bytes and ``improved`` equal JAX's on 2×4."""
    jplan, plan, _, _ = _plans(name)
    if jplan is None:
        assert plan is None
        return
    assert _families(plan) == _families(jplan)
    assert plan.default_cost_bytes == jplan.default_cost_bytes
    assert plan.planned_cost_bytes == jplan.planned_cost_bytes
    assert plan.improved == jplan.improved
    assert [c["entry"] for c in plan.scored_candidates] == \
        [c["entry"] for c in jplan.scored_candidates]
    assert [c["cost_bytes"] for c in plan.scored_candidates] == \
        [c["cost_bytes"] for c in jplan.scored_candidates]


def test_planner_beats_default_on_examples_2x4():
    """JAX's gate: at least two strict wins, no loss, and the decided
    placement lint-clean (zero KP6xx under the chosen plan)."""
    strict = 0
    for name in EXAMPLES_2X4:
        _, plan, pp, specs = _plans(name)
        assert plan is not None, name
        assert plan.planned_cost_bytes <= plan.default_cost_bytes
        if plan.improved:
            strict += 1
            _, diags, _ = sharding_pass(pp.graph, specs, mesh=LAYOUT,
                                        plan=plan.choices)
            assert not [d for d in diags if d.rule.startswith("KP6")], name
    assert strict >= 2


def _feature_pipeline(cosine, bcd, spec_ds, n=512, d=4096):
    features = cosine.to_pipeline()
    data = spec_ds((d,), np.float32, count=n, name="x")
    labels = spec_ds((8,), np.float32, count=n, name="y")
    return features.and_then(bcd, data, labels).apply(data)


def test_planner_row_sharded_featurize_model_parallel_solve():
    """A 2.5 MiB budget on 2×4 leaves the 512×4096 features only the
    data×model family (data-only 4 MiB, replicated 8 MiB a card): the
    featurize output is chosen row- and column-sharded, as JAX's."""
    budget = int(2.5 * (1 << 20))
    applied = _feature_pipeline(
        CosineRandomFeatures(4096, 4096, gamma=1.0, device="cpu"),
        BlockLeastSquaresEstimator(512, num_iter=1), SpecDataset)
    specs, _ = spec_pass(applied.graph, {})
    plan = plan_sharding(applied.graph, specs, mesh=LAYOUT,
                         hbm_budget_bytes=budget)
    feat = [v for v in plan.families if isinstance(v, NodeId) and
            "CosineRandomFeatures" in applied.graph.get_operator(v).label]
    assert feat
    for v in feat:
        assert plan.families[v] == FAMILY_DATA_MODEL
        assert tuple(plan.spec_for(v)) == ("data", "model")
    model = _CostModel(applied.graph, specs, LAYOUT, budget, 64 << 20)
    for v in feat:
        assert model.node_cost(v, FAMILY_DATA) == float("inf")
        assert model.node_cost(v, FAMILY_REPLICATED) == float("inf")
        assert model.node_cost(v, FAMILY_DATA_MODEL) < float("inf")
    mesh = _jax_mesh()
    with jmesh.use_mesh(mesh):
        japplied = _feature_pipeline(JaxCosine(4096, 4096, gamma=1.0),
                                     JaxBCD(512, num_iter=1),
                                     JaxSpecDataset)
        jspecs, _ = jax_spec_pass(japplied.graph, {})
        jplan = jax_plan_sharding(japplied.graph, jspecs, mesh=mesh,
                                  hbm_budget_bytes=budget)
    assert _families(plan) == _families(jplan)
    assert plan.planned_cost_bytes == jplan.planned_cost_bytes


class _HostStage(Transformer):
    def apply(self, x):
        return np.asarray(x).sum()


class _JaxHostStage(JaxTransformer):
    def apply(self, x):
        return np.asarray(x).sum()


def test_kp600_infeasible_menu_entries_pruned():
    """A host consumer makes replication the cheap choice; a 1 MiB budget
    that replication busts forces a sharded family, as in JAX."""
    applied = (RandomSignNode(1024, device="cpu").to_pipeline()
               >> _HostStage()).apply(
        SpecDataset((1024,), np.float32, count=1024, name="x"))
    specs, _ = spec_pass(applied.graph, {})
    sign = [v for v in applied.graph.operators
            if "RandomSignNode" in applied.graph.get_operator(v).label]
    free = plan_sharding(applied.graph, specs, mesh=LAYOUT)
    assert free is not None and free.improved
    assert all(free.families[v] == FAMILY_REPLICATED for v in sign)
    tight = plan_sharding(applied.graph, specs, mesh=LAYOUT,
                          hbm_budget_bytes=1 << 20)
    assert all(tight.families[v] != FAMILY_REPLICATED for v in sign)
    mesh = _jax_mesh()
    with jmesh.use_mesh(mesh):
        japplied = (JaxRandomSign(1024).to_pipeline()
                    >> _JaxHostStage()).apply(
            JaxSpecDataset((1024,), np.float32, count=1024, name="x"))
        jspecs, _ = jax_spec_pass(japplied.graph, {})
        jtight = jax_plan_sharding(japplied.graph, jspecs, mesh=mesh,
                                   hbm_budget_bytes=1 << 20)
    assert _families(tight) == _families(jtight)


def test_family_realization_and_classification_roundtrip():
    spec = SpecDataset((64,), np.float32, count=16, name="x").spec
    for fam in (FAMILY_DATA, FAMILY_DATA_MODEL, FAMILY_MODEL,
                FAMILY_REPLICATED):
        sv = realize_family(fam, spec, LAYOUT)
        assert sv is not None
        assert family_of(sv, LAYOUT) == fam
    odd = SpecDataset((13,), np.float32, count=16, name="x").spec
    assert realize_family(FAMILY_DATA_MODEL, odd, LAYOUT) is None
    assert realize_family(FAMILY_DATA, odd, LAYOUT) is not None


def test_planner_noop_on_one_card():
    applied = (RandomSignNode(16, device="cpu").to_pipeline()
               >> Transformer.from_function(lambda x: x)).apply(
        SpecDataset((16,), np.float32, count=8, name="x"))
    specs, _ = spec_pass(applied.graph, {})
    assert plan_sharding(applied.graph, specs) is None
    assert plan_sharding(applied.graph, specs, mesh={"data": 1}) is None


@pytest.mark.parametrize("kind", ["all_gather", "all_to_all", "broadcast"])
def test_collective_cost_bytes_equal_jax(kind):
    """One formula: the bytes each kind moves over 1–8 shards are JAX's;
    the seconds are those bytes at the card-to-card rate."""
    for shards in range(1, 9):
        for nbytes in (0, 1, 1000, 1 << 20, 12345678):
            got = meshlib.collective_cost(kind, nbytes, shards=shards)
            want = jmesh.collective_cost(kind, nbytes, shards=shards,
                                         mesh=_jax_mesh())
            assert got.bytes_moved == want.bytes_moved, (kind, shards)
            assert got.seconds == pytest.approx(
                got.bytes_moved * float(cost_model.NETWORK_WEIGHT))
    # the default: every card of the layout
    assert meshlib.collective_cost(kind, 800, mesh=LAYOUT).bytes_moved == \
        jmesh.collective_cost(kind, 800, mesh=_jax_mesh()).bytes_moved


def test_unified_planner_places_on_a_layout():
    """On 2×4 the unified planner's placement axis has a menu of more
    than one family (the sharding planner's), scores no worse than the
    sequential composition, and carries a `ShardingPlan` to enforce."""
    from keystone_tpu_torch.analysis.plan_ir import _UnifiedModel, plan_unified
    from keystone_tpu_torch.analysis.roofline import default_machine

    pp, src = build_example("TimitPipeline", device="cpu")
    specs, _ = spec_pass(pp.graph, {pp.source: as_source_spec(src)})
    model = _UnifiedModel(pp.graph, specs, LAYOUT, None, 2048,
                          default_machine())
    assert any(len(menu) > 1 for menu in model.fam_menus.values())
    uplan = plan_unified(pp.graph, specs, mesh=LAYOUT)
    assert uplan is not None and uplan.sharding is not None
    assert uplan.joint_seconds <= uplan.sequential_seconds
    assert set(uplan.chosen.fam().values()) <= {
        FAMILY_DATA, FAMILY_DATA_MODEL, FAMILY_MODEL, FAMILY_REPLICATED}


def _cli_json(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_cli_explain_sharding_plan_mesh_shape_equals_jax(capsys):
    """``--explain-sharding --plan --mesh-shape 2x4 --json``: the port's
    output equals JAX's apart from the argmax's width (int64)."""
    from keystone_tpu.analysis.__main__ import main as jax_main
    from keystone_tpu_torch.analysis.__main__ import main

    rc, got = _cli_json(main, ["--explain-sharding", "--plan",
                               "--mesh-shape", "2x4", "--json", "--device",
                               "cpu"], capsys)
    jrc, want = _cli_json(jax_main, ["--explain-sharding", "--plan",
                                     "--mesh-shape", "2x4", "--json"],
                          capsys)
    assert rc == jrc == 0
    assert got["devices"] == want["devices"] == 8
    assert [e["example"] for e in got["examples"]] == \
        [e["example"] for e in want["examples"]]
    for g, w in zip(got["examples"], want["examples"]):
        assert g["findings"] == w["findings"] == [], g["example"]
        assert g["planner"] is not None or w["planner"] is None
        if w["planner"] is not None:
            for key in ("planned_cost_bytes", "default_cost_bytes",
                        "savings_bytes", "improved", "changed_stages",
                        "stages"):
                assert g["planner"][key] == w["planner"][key], (
                    g["example"], key)
        for gs, ws in zip(g["stages"], w["stages"]):
            assert (gs["label"], gs["spec"], gs["boundary_bytes"]) == \
                (ws["label"], ws["spec"], ws["boundary_bytes"])
            want_pd = ws["per_device_bytes"]
            if ws["label"] == "MaxClassifier" and want_pd is not None:
                want_pd *= 2
            assert gs["per_device_bytes"] == want_pd, (g["example"],
                                                       gs["label"])


def test_cli_explain_unified_on_a_layout(capsys):
    from keystone_tpu_torch.analysis.__main__ import main

    rc, got = _cli_json(main, ["--explain-unified", "--mesh-shape", "2x4",
                               "--json", "--device", "cpu",
                               "TimitPipeline"], capsys)
    assert rc == 0
    assert got["devices"] == 8
    rec = got["examples"][0]
    assert rec["findings"] == [] or all(
        f["severity"] == "INFO" for f in rec["findings"])
    assert any(r.get("family") for r in rec["planner"]["stages"])
