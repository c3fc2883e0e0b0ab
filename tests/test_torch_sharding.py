"""The static sharding tier (`keystone_tpu_torch/analysis/sharding.py`)
against JAX's (`keystone_tpu/analysis/sharding.py`).

The same graphs go through both packages' passes on the same mesh shape:
JAX on a slice of the conftest's 8-device CPU mesh (the passes are spec
arithmetic, no collective runs), the port on a layout
(``{"data": 2, "model": 4}`` and the like), which needs no process. They
agree on each boundary's spec string, the rule ids and severities, the
per-device bytes (apart from `MaxClassifier`'s argmax, int64 in torch
against JAX's int32) and the priced boundary bytes. Each KP6xx rule is
mirrored from JAX's `tests/test_sharding.py`: it fires on the seeded
fault, stays quiet on the clean form and is suppressed by ``ignore``.
"""

import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from keystone_tpu.analysis import (
    PartitionRule as JaxRule,
    SpecDataset as JaxSpecDataset,
    as_source_spec as jax_as_source_spec,
    validate_graph as jax_validate,
)
from keystone_tpu.analysis.examples import EXAMPLES as JAX_EXAMPLES
from keystone_tpu.analysis.examples import build_example as jax_build
from keystone_tpu.analysis.memory import memory_pass as jax_memory
from keystone_tpu.analysis.propagate import spec_pass as jax_spec_pass
from keystone_tpu.analysis.sharding import (
    ShardedValue as JaxShardedValue,
    explain_rows as jax_explain_rows,
    per_device_pass as jax_per_device_pass,
    sharding_pass as jax_sharding_pass,
    spec_str as jax_spec_str,
)
from keystone_tpu.nodes.stats import (
    LinearRectifier as JaxRectifier,
    RandomSignNode as JaxRandomSign,
)
from keystone_tpu.parallel import mesh as jmesh
from keystone_tpu.workflow import Transformer as JaxTransformer

from keystone_tpu_torch.analysis import (
    PartitionRule,
    SpecDataset,
    as_source_spec,
    validate_graph,
)
from keystone_tpu_torch.analysis.examples import EXAMPLES, build_example
from keystone_tpu_torch.analysis.memory import memory_pass
from keystone_tpu_torch.analysis.propagate import spec_pass
from keystone_tpu_torch.analysis.sharding import (
    DEMAND_DATA_SHARDED,
    ShardedValue,
    ShardingResult,
    explain_rows,
    format_explain,
    per_device_bytes,
    per_device_pass,
    seed_sharding,
    sharding_pass,
    spec_str,
)
from keystone_tpu_torch.analysis.specs import DataSpec, shape_struct
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import LinearRectifier, RandomSignNode
from keystone_tpu_torch.parallel import P
from keystone_tpu_torch.workflow import Transformer

#: the port's layout for each JAX mesh shape the tests take
SHAPES = {"2x4": (2, 4), "4x2": (4, 2), "8x1": (8, 1)}


def _jax_mesh(shape):
    d, m = shape
    return jmesh.make_mesh(jax.devices()[:d * m], shape=(d, m),
                           axis_names=(jmesh.DATA_AXIS, jmesh.MODEL_AXIS))


def _layout(shape):
    return {"data": shape[0], "model": shape[1]}


#: the conftest's default JAX mesh: 8 devices on ``data``
DATA8 = {"data": 8}


class _HostStage(Transformer):
    """A provably host stage: its meta run dies on the numpy pull."""

    def apply(self, x):
        return np.asarray(x).sum()


class _JaxHostStage(JaxTransformer):
    def apply(self, x):
        return np.asarray(x).sum()


def _chain(dim=16, count=64):
    pipe = RandomSignNode(dim, device="cpu").to_pipeline() \
        >> LinearRectifier(0.0)
    return pipe.apply(SpecDataset((dim,), np.float32, count=count,
                                  name="x"))


def _jax_chain(dim=16, count=64):
    pipe = JaxRandomSign(dim).to_pipeline() >> JaxRectifier(0.0)
    return pipe.apply(JaxSpecDataset((dim,), np.float32, count=count,
                                     name="x"))


def _full(graph, mesh=DATA8, **kwargs):
    return validate_graph(graph, level="full", mesh=mesh, **kwargs)


def _rules(report):
    return sorted((d.rule, d.severity.name) for d in report.diagnostics
                  if d.rule.startswith("KP6"))


# ------------------------------------------------------ the examples, both


def _both_passes(name, shape):
    mesh = _jax_mesh(shape)
    with jmesh.use_mesh(mesh):
        jp, jsrc = jax_build(name)
        jspecs, _ = jax_spec_pass(jp.graph,
                                  {jp.source: jax_as_source_spec(jsrc)})
        jsh, jd, jb = jax_sharding_pass(jp.graph, jspecs, mesh=mesh)
        jest, _ = jax_memory(jp.graph, jspecs)
        jpd, jpdd = jax_per_device_pass(jp.graph, jspecs, jsh, jest,
                                        mesh=mesh, hbm_budget_bytes=1 << 20)
        jrows = jax_explain_rows(jp.graph, jspecs, jsh, jb, jpd)
    pp, psrc = build_example(name, device="cpu")
    pspecs, _ = spec_pass(pp.graph, {pp.source: as_source_spec(psrc)})
    layout = _layout(shape)
    psh, pd, pb = sharding_pass(pp.graph, pspecs, mesh=layout)
    pest, _ = memory_pass(pp.graph, pspecs)
    ppd, ppdd = per_device_pass(pp.graph, pspecs, psh, pest, mesh=layout,
                                hbm_budget_bytes=1 << 20)
    prows = explain_rows(pp.graph, pspecs, psh, pb, ppd)
    return (jrows, jd + jpdd, jest), (prows, pd + ppdd, pest)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(JAX_EXAMPLES))
def test_examples_equal_jax_on_a_mesh(name, shape):
    """Every example's stage specs, rule ids and severities, per-device
    bytes and boundary bytes on the mesh shape equal JAX's (the argmax
    of `MaxClassifier` is int64 here: its bytes are twice JAX's)."""
    assert sorted(EXAMPLES) == sorted(JAX_EXAMPLES)
    (jrows, jdiags, jest), (prows, pdiags, pest) = _both_passes(
        name, SHAPES[shape])
    assert [r["label"] for r in prows] == [r["label"] for r in jrows]
    for j, p in zip(jrows, prows):
        assert p["spec"] == j["spec"], (p["label"], p["spec"], j["spec"])
        assert p["boundary_bytes"] == j["boundary_bytes"], p["label"]
        want = j["per_device_bytes"]
        if p["label"] == "MaxClassifier" and want is not None:
            want *= 2
        assert p["per_device_bytes"] == want, (p["label"],
                                               p["per_device_bytes"], want)
    assert sorted((d.rule, d.severity.name) for d in pdiags) == \
        sorted((d.rule, d.severity.name) for d in jdiags)


@pytest.mark.parametrize("name", sorted(JAX_EXAMPLES))
def test_example_pipelines_have_zero_kp6xx(name):
    """JAX's `test_example_pipelines_have_zero_kp6xx`, on 2x4 and on
    the data-parallel 8x1."""
    for shape in ((2, 4), (8, 1)):
        pipeline, src = build_example(name, device="cpu")
        report = pipeline.validate(src, raise_on_error=False,
                                   mesh=_layout(shape))
        assert not _rules(report), (name, shape, _rules(report))


# ------------------------------------------------------------ propagation


def test_data_sharding_survives_elementwise_chain():
    report = _full(_chain().graph)
    node_svs = {v: sv for v, sv in report.shardings.items()
                if sv is not None}
    assert len(node_svs) >= 3
    for sv in node_svs.values():
        assert spec_str(sv).startswith("P('data'")
    assert not _rules(report)
    jreport = jax_validate(_jax_chain().graph, level="full")
    assert sorted(spec_str(sv) for sv in node_svs.values()) == sorted(
        jax_spec_str(sv) for sv in jreport.shardings.values()
        if sv is not None)


def test_sharding_only_runs_at_full_level():
    graph = _chain().graph
    assert not validate_graph(graph, level="memory", mesh=DATA8).shardings
    assert validate_graph(graph, level="full", mesh=DATA8).shardings


# ------------------------------------------------------- KP601 (reshard)


def test_kp601_partition_rule_override_fires_and_suppresses():
    graph = _chain().graph
    rules = [PartitionRule("LinearRectifier", P())]
    report = _full(graph, partition_rules=rules)
    kp601 = report.by_rule("KP601")
    assert kp601 and "all-to-all" in kp601[0].message
    assert spec_str(report.shardings[kp601[0].vertex]) == "P()"
    assert not _full(graph, partition_rules=rules,
                     ignore=["KP601"]).by_rule("KP601")
    assert not _full(graph).by_rule("KP601")
    jreport = jax_validate(_jax_chain().graph, level="full",
                           partition_rules=[JaxRule("LinearRectifier",
                                                    JP())])
    assert _rules(report) == _rules(jreport)


def test_kp601_solver_demand_fires_on_replicated_input():
    from keystone_tpu.nodes.learning import (
        BlockLeastSquaresEstimator as JaxBCD,
    )

    feat = RandomSignNode(8, device="cpu").to_pipeline()
    data = SpecDataset((8,), np.float32, count=32, name="d")
    labels = SpecDataset((4,), np.float32, count=32, name="l")
    pred = feat.and_then(BlockLeastSquaresEstimator(8, 1, 0.1), data, labels)
    report = validate_graph(pred.graph, {pred.source: (8,)}, level="full",
                            mesh=DATA8,
                            partition_rules=[("RandomSignNode", P())])
    hits = [d for d in report.by_rule("KP601")
            if "demands a data-sharded layout" in d.message]
    assert hits
    clean = validate_graph(pred.graph, {pred.source: (8,)}, level="full",
                           mesh=DATA8)
    assert not clean.by_rule("KP601")
    jfeat = JaxRandomSign(8).to_pipeline()
    jpred = jfeat.and_then(
        JaxBCD(8, 1, 0.1), JaxSpecDataset((8,), np.float32, count=32),
        JaxSpecDataset((4,), np.float32, count=32))
    jreport = jax_validate(jpred.graph, {jpred.source: (8,)}, level="full",
                           partition_rules=[("RandomSignNode", JP())])
    assert _rules(report) == _rules(jreport)


def test_solver_fit_hooks_declare_row_sharded_demands():
    from keystone_tpu_torch.nodes.learning import (
        DenseLBFGSwithL2,
        DistributedPCAEstimator,
        KernelRidgeRegression,
    )

    for est, n in [(BlockLeastSquaresEstimator(8, 1), 2),
                   (KernelRidgeRegression(1.0, 0.1), 2),
                   (DenseLBFGSwithL2(), 2),
                   (DistributedPCAEstimator(4), 1)]:
        res = est.abstract_sharding([None] * n, [None] * n)
        assert isinstance(res, ShardingResult)
        assert res.demands == (DEMAND_DATA_SHARDED,) * n, type(est).__name__


# -------------------------------------------------- KP605 (invalid rule)


def test_kp605_rule_with_unknown_axis_or_excess_rank():
    graph = _chain().graph
    bad = _full(graph, partition_rules=[("LinearRectifier", P("expert"))])
    kp605 = bad.by_rule("KP605")
    assert kp605 and kp605[0].severity.name == "ERROR"
    assert "no axis 'expert'" in kp605[0].message
    assert spec_str(bad.shardings[kp605[0].vertex]) == "P('data', None)"
    assert _full(graph, partition_rules=[
        ("LinearRectifier", P("data", None, None))]).by_rule("KP605")
    assert not _full(graph, partition_rules=[
        ("LinearRectifier", P("data"))]).by_rule("KP605")


def test_rules_never_pin_device_specs_on_host_values():
    pipe = _HostStage().to_pipeline() >> _HostStage()
    applied = pipe.apply(SpecDataset(count=64, name="h", on_device=False))
    report = _full(applied.graph, partition_rules=[(".*", P("data"))])
    assert all(sv is None for sv in report.shardings.values())
    assert not report.by_rule("KP603")


def test_kp605_rejects_unrealizable_hook_placement():
    class _BadHookStage(Transformer):
        def apply(self, x):
            return x * 2.0

        def abstract_sharding(self, in_shardings, in_specs):
            return ShardedValue(P("expert"))

    applied = _BadHookStage().to_pipeline().apply(
        SpecDataset((16,), np.float32, count=64, name="x"))
    report = _full(applied.graph)
    kp605 = report.by_rule("KP605")
    assert kp605 and "no axis 'expert'" in kp605[0].message
    assert spec_str(report.shardings[kp605[0].vertex]).startswith("P('data'")


def test_kp605_raising_hook_is_loud_not_silent():
    class _RaisingHookStage(Transformer):
        def apply(self, x):
            return x * 2.0

        def abstract_sharding(self, in_shardings, in_specs):
            raise TypeError("refactor broke me")

    applied = _RaisingHookStage().to_pipeline().apply(
        SpecDataset((16,), np.float32, count=64, name="x"))
    report = _full(applied.graph)
    kp605 = report.by_rule("KP605")
    assert kp605 and "refactor broke me" in kp605[0].message
    assert kp605[0].severity.name == "WARNING"
    assert spec_str(report.shardings[kp605[0].vertex]).startswith("P('data'")


def test_per_device_bytes_models_padded_shards_at_ragged_counts():
    """12 rows over 8 data shards: a shard holds ceil(12/8) = 2 rows, as
    JAX's placed shard does."""
    from keystone_tpu.analysis.sharding import (
        per_device_bytes as jax_pdb,
        seed_sharding as jax_seed,
    )
    from keystone_tpu.analysis.specs import (
        DataSpec as JaxDataSpec,
        shape_struct as jax_struct,
    )

    spec = DataSpec(element=shape_struct((1024,), np.float32), count=12)
    static = per_device_bytes(spec, seed_sharding(spec, DATA8), DATA8)
    jspec = JaxDataSpec(element=jax_struct((1024,), np.float32), count=12)
    mesh = jmesh.current_mesh()
    assert static == jax_pdb(jspec, jax_seed(jspec, mesh), mesh) == 2 * 4096


# --------------------------------------------------- KP602 (replication)


def test_kp602_large_replicated_operand_on_model_mesh():
    layout = _layout((2, 4))
    big = SpecDataset((4096,), np.float32, count=8192, name="big")
    applied = Transformer.from_function(lambda x: x,
                                        name="ident").to_pipeline()(big)
    report = _full(applied.graph, mesh=layout, partition_rules=[(".", P())])
    kp602 = report.by_rule("KP602")
    assert kp602 and "'model'" in kp602[0].message
    assert not _full(applied.graph, mesh=layout).by_rule("KP602")
    assert not _full(applied.graph, mesh=layout, partition_rules=[
        (".", P())], ignore=["KP602"]).by_rule("KP602")
    with jmesh.use_mesh(_jax_mesh((2, 4))):
        jbig = JaxSpecDataset((4096,), np.float32, count=8192, name="big")
        japplied = JaxTransformer.from_function(
            lambda x: x, name="ident").to_pipeline()(jbig)
        jreport = jax_validate(japplied.graph, level="full",
                               partition_rules=[(".", JP())])
    assert _rules(report) == _rules(jreport)


def test_kp602_quiet_below_threshold():
    small = SpecDataset((64,), np.float32, count=128, name="small")
    applied = Transformer.from_function(lambda x: x,
                                        name="ident").to_pipeline()(small)
    report = _full(applied.graph, mesh=_layout((2, 4)),
                   partition_rules=[(".", P())])
    assert not report.by_rule("KP602")


# ------------------------------------------------- KP603 (host all-gather)


def test_kp603_host_stage_consuming_sharded_data():
    pipe = RandomSignNode(16, device="cpu").to_pipeline() >> _HostStage()
    applied = pipe.apply(SpecDataset((16,), np.float32, count=64, name="x"))
    report = _full(applied.graph)
    kp603 = report.by_rule("KP603")
    assert kp603 and "all-gather" in kp603[0].message
    assert not _full(applied.graph, ignore=["KP603"]).by_rule("KP603")
    jpipe = JaxRandomSign(16).to_pipeline() >> _JaxHostStage()
    japplied = jpipe.apply(JaxSpecDataset((16,), np.float32, count=64))
    jreport = jax_validate(japplied.graph, level="full")
    assert _rules(report) == _rules(jreport)
    assert kp603[0].message.split("(≈")[1] == \
        jreport.by_rule("KP603")[0].message.split("(≈")[1]


def test_kp603_quiet_for_host_to_host():
    pipe = _HostStage().to_pipeline() >> _HostStage()
    applied = pipe.apply(SpecDataset(count=64, name="h", on_device=False))
    assert not _full(applied.graph).by_rule("KP603")


# ------------------------------------------- KP604 (indivisible counts)


def test_kp604_mesh_indivisible_count():
    report = _full(_chain(count=30).graph)
    kp604 = report.by_rule("KP604")
    assert kp604 and "pads to 32" in kp604[0].message
    assert len(kp604) == 1
    assert not _full(_chain(count=30).graph,
                     ignore=["KP604"]).by_rule("KP604")
    assert not _full(_chain(count=32).graph).by_rule("KP604")
    jreport = jax_validate(_jax_chain(count=30).graph, level="full")
    assert kp604[0].message == jreport.by_rule("KP604")[0].message


# ----------------------------------------------- per-device memory model


def test_per_device_peak_divides_fleet_peak_by_shards():
    report = _full(_chain(dim=16, count=64).graph)
    mem = report.memory
    assert mem.per_device_peak_bytes > 0
    assert mem.per_device_peak_bytes == mem.peak_bytes // 8
    jmem = jax_validate(_jax_chain(dim=16, count=64).graph,
                        level="full").memory
    assert mem.per_device_peak_bytes == jmem.per_device_peak_bytes


def test_kp600_per_device_budget_replaces_kp202():
    """KP600 on the per-device budget, and the bytes equal to JAX's.

    Both memory passes stream a chain's output in chunks of the
    execution config's chunk rows, six in flight. The port's default
    chunk is 1,024 rows (`keystone_tpu_torch/workflow/env.py`), JAX's
    256; six 1,024-row chunks of 1 KiB rows outweigh the 4,096-row
    stage, so at its own default the port charges each stage whole
    (2 × 4 MiB). Given JAX's chunk, its peaks are JAX's."""
    from keystone_tpu.workflow.env import execution_config as jax_config

    chunk = jax_config().chunk_size
    graph = _chain(dim=256, count=4096).graph
    tight = _full(graph, hbm_budget_bytes=256 << 10, chunk_rows=chunk)
    assert tight.by_rule("KP600") and not tight.by_rule("KP202")
    mem = tight.memory
    assert mem.per_device_peak_bytes < mem.peak_bytes
    mid = _full(graph, chunk_rows=chunk,
                hbm_budget_bytes=(mem.per_device_peak_bytes
                                  + mem.peak_bytes) // 2)
    assert not mid.by_rule("KP600") and not mid.by_rule("KP202")
    jtight = jax_validate(_jax_chain(dim=256, count=4096).graph,
                          level="full", hbm_budget_bytes=256 << 10)
    assert jtight.by_rule("KP600") and not jtight.by_rule("KP202")
    # JAX's 8-device mesh against DATA8: the fleet peak and a device's
    assert mem.peak_bytes == jtight.memory.peak_bytes
    assert mem.per_device_peak_bytes == jtight.memory.per_device_peak_bytes
    assert mem.per_device_peak_bytes == mem.peak_bytes // 8
    # one card: the per-device peak is the fleet peak, JAX's
    one = validate_graph(graph, level="full", chunk_rows=chunk).memory
    assert one.peak_bytes == one.per_device_peak_bytes \
        == jtight.memory.peak_bytes
    # the port's own chunk streams nothing here: each stage whole
    own = validate_graph(graph, level="full").memory
    assert own.peak_bytes == 2 * 4096 * 256 * 4


def test_one_card_has_no_kp6xx_and_kp600_in_kp202_place():
    """With no mesh (one card) nothing is split: the per-device peak is
    the memory model's, and the budget finding is KP600."""
    graph = _chain(dim=256, count=4096).graph
    report = validate_graph(graph, level="full", hbm_budget_bytes=256 << 10)
    assert [d.rule for d in report.diagnostics
            if d.rule.startswith("KP6")] == ["KP600"]
    assert report.memory.per_device_peak_bytes == report.memory.peak_bytes


# ------------------------------------------------------- explain surface


def test_explain_rows_and_table():
    applied = _chain()
    graph = applied.graph
    specs, _ = spec_pass(graph, {})
    shardings, _, boundary = sharding_pass(graph, specs, mesh=DATA8)
    est, _ = memory_pass(graph, specs)
    per_dev, _ = per_device_pass(graph, specs, shardings, est, mesh=DATA8)
    rows = explain_rows(graph, specs, shardings, boundary, per_dev)
    assert rows and all(set(r) >= {"vertex", "label", "spec",
                                   "per_device_bytes", "boundary_bytes"}
                        for r in rows)
    table = format_explain(rows)
    assert "per-dev" in table and "P('data'" in table
    from keystone_tpu.analysis.sharding import format_explain as jax_format

    jgraph = _jax_chain().graph
    jspecs, _ = jax_spec_pass(jgraph, {})
    jsh, _, jb = jax_sharding_pass(jgraph, jspecs)
    jest, _ = jax_memory(jgraph, jspecs)
    jpd, _ = jax_per_device_pass(jgraph, jspecs, jsh, jest)
    assert table == jax_format(jax_explain_rows(jgraph, jspecs, jsh, jb, jpd))


def test_sharded_value_specs_are_leaves():
    sv = ShardedValue((P("data", "model"), P("data")))
    assert sv.leaf_specs() == [P("data", "model"), P("data")]
    assert spec_str(sv) == "(P('data', 'model'), P('data'))"
    jsv = JaxShardedValue((JP("data", "model"), JP("data")))
    assert spec_str(sv) == jax_spec_str(jsv)
    assert sv.max_shards({"data": 2, "model": 4}) == 8


# -------------------------------------------------------------- the CLI


def test_explain_sharding_cli_all_examples_clean(capsys):
    from keystone_tpu_torch.analysis.__main__ import main

    rc = main(["--explain-sharding", "--device", "cpu", "--mesh-shape",
               "2x4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for name in EXAMPLES:
        assert f"✓ {name}" in out
    assert "P('data'" in out and "mesh: 8 device(s)" in out


def test_explain_sharding_cli_json(capsys):
    from keystone_tpu_torch.analysis.__main__ import main

    rc = main(["--explain-sharding", "--json", "--device", "cpu",
               "--mesh-shape", "8x1", "MnistRandomFFT"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["devices"] == 8
    ex = payload["examples"][0]
    assert ex["example"] == "MnistRandomFFT"
    assert ex["findings"] == []
    assert ex["stages"] and all("spec" in s for s in ex["stages"])


def test_mesh_shape_must_be_data_by_model(capsys):
    from keystone_tpu_torch.analysis.__main__ import main

    assert main(["--explain-sharding", "--device", "cpu", "--mesh-shape",
                 "2x"]) == 2
    assert "DATAxMODEL" in capsys.readouterr().err
