"""The port's workflow graph, its topology queries, the structural check,
expressions, operators and the pickle format, on the CPU.

`tests/test_graph.py`'s cases (reference GraphSuite.scala:41-790,
AnalysisUtilsSuite.scala:39-287) run on both packages' `Graph` and
`workflow/analysis.py`, which must behave the same; cases that repeat
each other's shape are parametrized. The structural check's rules
(KP001-KP005) are held to the JAX package's verdicts on the same graphs.
"""

import pickle

import numpy as np
import pytest
import torch

import keystone_tpu.workflow as jax_workflow
from keystone_tpu.analysis import structural_report as jax_structural_report
from keystone_tpu.workflow.pipeline import Transformer as JaxTransformer
import keystone_tpu_torch.workflow as port_workflow
from keystone_tpu_torch.analysis import (
    PipelineValidationError,
    structural_report,
)
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.utils.serialization import (
    load_pytree_pickle,
    save_pytree_pickle,
)
from keystone_tpu_torch.workflow import (
    DatasetExpression,
    DatasetOperator,
    DatumExpression,
    DelegatingOperator,
    Expression,
    ExpressionOperator,
    GatherTransformerOperator,
    GraphExecutor,
    PipelineEnv,
    TransformerExpression,
)
from keystone_tpu_torch.workflow.operators import fitted_elem_fn
from keystone_tpu_torch.workflow.pipeline import Estimator, Transformer

PACKAGES = {"port": (port_workflow, Transformer),
            "jax": (jax_workflow, JaxTransformer)}


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def op(pkg, name="op"):
    return pkg[1].from_function(lambda x: x, name=name)


def build_chain(pkg):
    """source -> a -> b -> sink"""
    w = pkg[0]
    g = w.Graph()
    g, s = g.add_source()
    g, a = g.add_node(op(pkg, "a"), [s])
    g, b = g.add_node(op(pkg, "b"), [a])
    g, k = g.add_sink(b)
    return g, s, a, b, k


def build_diamond(pkg):
    """source -> a -> {b, c} -> d -> sink1; b -> sink2."""
    g = pkg[0].Graph()
    g, s = g.add_source()
    g, a = g.add_node(op(pkg, "a"), [s])
    g, b = g.add_node(op(pkg, "b"), [a])
    g, c = g.add_node(op(pkg, "c"), [a])
    g, d = g.add_node(op(pkg, "d"), [b, c])
    g, k1 = g.add_sink(d)
    g, k2 = g.add_sink(b)
    return g, s, a, b, c, d, k1, k2


def one_node_replacement(pkg, sinks=1):
    w = pkg[0]
    r = w.Graph()
    r, rs = r.add_source()
    r, rn = r.add_node(op(pkg, "r"), [rs])
    ks = []
    for _ in range(sinks):
        r, rk = r.add_sink(rn)
        ks.append(rk)
    return r, rs, rn, ks


# ---- views and mutators ----------------------------------------------------


def test_add_node_and_views(pkg):
    g, s, a, b, k = build_chain(pkg)
    assert g.sources == {s}
    assert g.nodes == {a, b}
    assert g.sink_ids == {k}
    assert g.get_dependencies(b) == (a,)
    assert g.get_sink_dependency(k) == b


def test_remove_leaf_node(pkg):
    g, s, a, b, k = build_chain(pkg)
    g = g.remove_sink(k).remove_node(b)
    assert g.nodes == {a} and k not in g.sink_ids


def test_set_operator_and_dependencies(pkg):
    g, s, a, b, k = build_chain(pkg)
    new_op = op(pkg, "c")
    g2 = g.set_operator(b, new_op)
    assert g2.get_operator(b) is new_op
    assert g.get_operator(b) is not new_op  # immutability
    assert g2.set_dependencies(b, [s]).get_dependencies(b) == (s,)


def test_replace_dependency(pkg):
    g, s, a, b, k = build_chain(pkg)
    assert g.replace_dependency(b, a).get_sink_dependency(k) == a


def test_immutability_of_mutators(pkg):
    g, s, a, b, k = build_chain(pkg)
    g.add_node(op(pkg), [a])
    assert g.nodes == {a, b}


def test_add_graph_remaps_ids(pkg):
    g1, s1, a1, b1, k1 = build_chain(pkg)
    g2, s2, a2, b2, k2 = build_chain(pkg)
    merged, smap, kmap = g1.add_graph(g2)
    assert (len(merged.nodes), len(merged.sources),
            len(merged.sink_ids)) == (4, 2, 2)
    assert smap[s2] != s1
    dep = merged.get_sink_dependency(kmap[k2])
    assert merged.get_dependencies(dep)[0] in merged.nodes


def test_connect_graph_splices_source(pkg):
    g1, s1, a1, b1, k1 = build_chain(pkg)
    g2, s2, a2, b2, k2 = build_chain(pkg)
    merged, kmap = g1.connect_graph(g2, {s2: b1})
    assert len(merged.sources) == 1
    tail = merged.get_sink_dependency(kmap[k2])
    head = merged.get_dependencies(tail)[0]
    assert merged.get_dependencies(head) == (b1,)


def test_connect_graph_partial_splice_keeps_source(pkg):
    g, s, a, b, k = build_chain(pkg)
    other = pkg[0].Graph()
    other, o1 = other.add_source()
    other, o2 = other.add_source()
    other, on = other.add_node(op(pkg), [o1, o2])
    other, _ = other.add_sink(on)
    g2, _ = g.connect_graph(other, {o1: b})
    assert len(g2.sources) == 2


def test_replace_nodes(pkg):
    g, s, a, b, k = build_chain(pkg)
    r, rs, rn, (rk,) = one_node_replacement(pkg)
    g2 = g.replace_nodes([b], r, {rs: a}, {b: rk})
    tail = g2.get_sink_dependency(k)
    assert b not in g2.nodes and g2.get_operator(tail).label == "r"
    assert g2.get_dependencies(tail) == (a,)


def test_replace_nodes_happy_path_two_nodes(pkg):
    g, s, a, b, k = build_chain(pkg)
    r, rs, rn, (rk,) = one_node_replacement(pkg)
    g2 = g.replace_nodes([a, b], r, {rs: s}, {a: rk, b: rk})
    assert a not in g2.operators and b not in g2.operators
    new_dep = g2.get_sink_dependency(k)
    assert isinstance(new_dep, pkg[0].NodeId) and new_dep in g2.operators
    assert g2.get_dependencies(new_dep) == (s,)


def test_to_dot_contains_all_vertices(pkg):
    g, s, a, b, k = build_chain(pkg)
    dot = g.to_dot()
    assert f"source_{s.id}" in dot and f"sink_{k.id}" in dot
    assert f"node_{a.id}" in dot and '[label="0"]' in dot


# ---- every failing branch of the mutators and accessors --------------------

def _two_source_replacement(pkg):
    w = pkg[0]
    r = w.Graph()
    r, r1 = r.add_source()
    r, r2 = r.add_source()
    r, rn = r.add_node(op(pkg), [r1, r2])
    r, rk = r.add_sink(rn)
    return r, r1, rk


def _other(pkg):
    r, rs, rn, (rk,) = one_node_replacement(pkg)
    return r, rs


FAILURES = {
    "add_node_missing_node_dep": (ValueError, lambda p, g, s, a, b, k, w: (
        w.Graph().add_node(op(p), [w.NodeId(42)]))),
    "add_node_missing_source_dep": (ValueError, lambda p, g, s, a, b, k, w: (
        w.Graph().add_node(op(p), [w.SourceId(99)]))),
    "add_node_bad_dep_type": (TypeError, lambda p, g, s, a, b, k, w: (
        w.Graph().add_node(op(p), [w.SinkId(0)]))),
    "add_sink_missing_dep": (ValueError, lambda p, g, s, a, b, k, w: (
        w.Graph().add_sink(w.NodeId(0)))),
    "remove_node_with_node_user": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_node(a))),
    "remove_node_with_sink_user": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_node(b))),
    "remove_source_with_users": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_source(s))),
    "set_operator_missing_node": (ValueError, lambda p, g, s, a, b, k, w: (
        g.set_operator(w.NodeId(99), op(p)))),
    "set_dependencies_missing_node": (ValueError,
                                      lambda p, g, s, a, b, k, w: (
                                          g.set_dependencies(w.NodeId(99),
                                                             [s]))),
    "set_dependencies_missing_dep": (ValueError, lambda p, g, s, a, b, k, w: (
        g.set_dependencies(a, [w.NodeId(99)]))),
    "set_sink_dependency_missing_sink": (ValueError,
                                         lambda p, g, s, a, b, k, w: (
                                             g.set_sink_dependency(
                                                 w.SinkId(99), a))),
    "set_sink_dependency_missing_dep": (ValueError,
                                        lambda p, g, s, a, b, k, w: (
                                            g.set_sink_dependency(
                                                k, w.NodeId(99)))),
    "remove_node_missing": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_node(w.NodeId(99)))),
    "remove_source_missing": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_source(w.SourceId(99)))),
    "remove_sink_missing": (ValueError, lambda p, g, s, a, b, k, w: (
        g.remove_sink(w.SinkId(99)))),
    "replace_dependency_missing_new": (ValueError,
                                       lambda p, g, s, a, b, k, w: (
                                           g.replace_dependency(
                                               a, w.NodeId(99)))),
    "connect_graph_nonsource_splice_key": (
        ValueError, lambda p, g, s, a, b, k, w: g.connect_graph(
            _other(p)[0], {w.SourceId(57): a})),
    "connect_graph_dangling_node_target": (
        ValueError, lambda p, g, s, a, b, k, w: g.connect_graph(
            *(lambda o: (o[0], {o[1]: w.NodeId(99)}))(_other(p)))),
    "connect_graph_dangling_source_target": (
        ValueError, lambda p, g, s, a, b, k, w: g.connect_graph(
            *(lambda o: (o[0], {o[1]: w.SourceId(99)}))(_other(p)))),
    "replace_nodes_empty_set": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([], r[0], {r[1]: s}, {}))(
                one_node_replacement(p))),
    "replace_nodes_missing_node": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([w.NodeId(99)], r[0], {r[1]: s},
                                      {w.NodeId(99): r[3][0]}))(
                one_node_replacement(p))),
    "replace_nodes_sink_splice_mismatch": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([a], r[0], {r[1]: s}, {b: r[3][0]}))(
                one_node_replacement(p))),
    "replace_nodes_removed_splice_target": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([a, b], r[0], {r[1]: a},
                                      {a: r[3][0], b: r[3][0]}))(
                one_node_replacement(p))),
    "replace_nodes_unbound_replacement_source": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([b], r[0], {r[1]: s}, {b: r[2]}))(
                _two_source_replacement(p))),
    "replace_nodes_unattached_replacement_sink": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([b], r[0], {r[1]: s}, {b: r[3][0]}))(
                one_node_replacement(p, sinks=2))),
    "replace_nodes_dangling_source_target": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([b], r[0], {r[1]: w.SourceId(-42)},
                                      {b: r[3][0]}))(
                one_node_replacement(p))),
    "replace_nodes_missing_node_target": (
        ValueError, lambda p, g, s, a, b, k, w: (
            lambda r: g.replace_nodes([b], r[0], {r[1]: w.NodeId(99)},
                                      {b: r[3][0]}))(
                one_node_replacement(p))),
    "get_operator_missing": (KeyError, lambda p, g, s, a, b, k, w: (
        g.get_operator(w.NodeId(99)))),
    "get_dependencies_missing": (KeyError, lambda p, g, s, a, b, k, w: (
        g.get_dependencies(w.NodeId(99)))),
    "get_sink_dependency_missing": (KeyError, lambda p, g, s, a, b, k, w: (
        g.get_sink_dependency(w.SinkId(99)))),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_graph_rejects(pkg, case):
    """Each `require` of Graph.scala:110-434 (and each accessor of a
    missing vertex) raises the same error type in both packages."""
    err, call = FAILURES[case]
    g, s, a, b, k = build_chain(pkg)
    with pytest.raises(err):
        call(pkg, g, s, a, b, k, pkg[0])


# ---- topology queries --------------------------------------------------------


def test_linearize_deterministic_topo_order(pkg):
    g, s, a, b, k = build_chain(pkg)
    order = pkg[0].analysis.linearize(g, k)
    assert order.index(s) < order.index(a) < order.index(b) < order.index(k)


def test_ancestors_descendants_children_parents(pkg):
    g, s, a, b, k = build_chain(pkg)
    an = pkg[0].analysis
    assert an.ancestors(g, k) == {s, a, b}
    assert an.descendants(g, s) == {a, b, k}
    assert an.children(g, a) == {b}
    assert an.parents(g, b) == [a]


def test_children_per_vertex_kind(pkg):
    g, s, a, b, c, d, k1, k2 = build_diamond(pkg)
    an = pkg[0].analysis
    assert an.children(g, s) == {a}
    assert an.children(g, a) == {b, c}
    assert an.children(g, b) == {d, k2}
    assert an.children(g, d) == {k1}
    assert an.children(g, k1) == set()


def test_parents_per_vertex_kind(pkg):
    g, s, a, b, c, d, k1, k2 = build_diamond(pkg)
    an = pkg[0].analysis
    assert an.parents(g, a) == [s]
    assert set(an.parents(g, d)) == {b, c}
    assert an.parents(g, k1) == [d] and an.parents(g, k2) == [b]
    assert an.parents(g, s) == []


def test_descendants_include_sinks(pkg):
    g, s, a, b, c, d, k1, k2 = build_diamond(pkg)
    an = pkg[0].analysis
    assert an.descendants(g, s) == {a, b, c, d, k1, k2}
    assert an.descendants(g, b) == {d, k1, k2}
    assert an.descendants(g, c) == {d, k1}
    assert an.descendants(g, d) == {k1}


def test_ancestors_include_sources(pkg):
    g, s, a, b, c, d, k1, k2 = build_diamond(pkg)
    an = pkg[0].analysis
    assert an.ancestors(g, k1) == {s, a, b, c, d}
    assert an.ancestors(g, k2) == {s, a, b}
    assert an.ancestors(g, d) == {s, a, b, c}
    assert an.ancestors(g, a) == {s} and an.ancestors(g, s) == set()


def test_linearize_respects_dependencies_and_is_deterministic(pkg):
    g, s, a, b, c, d, k1, k2 = build_diamond(pkg)
    order = pkg[0].analysis.linearize(g)
    pos = {v: i for i, v in enumerate(order)}
    for node in (a, b, c, d):
        for dep in g.get_dependencies(node):
            assert pos[dep] < pos[node]
    assert order == pkg[0].analysis.linearize(g)
    g2 = build_diamond(pkg)[0]
    assert [type(v).__name__ for v in pkg[0].analysis.linearize(g2)] == [
        type(v).__name__ for v in order]


def test_linearize_orders_match_across_packages():
    port = build_diamond(PACKAGES["port"])[0]
    ref = build_diamond(PACKAGES["jax"])[0]
    assert [(type(v).__name__, v.id) for v in
            port_workflow.analysis.linearize(port)] == [
        (type(v).__name__, v.id) for v in
        jax_workflow.analysis.linearize(ref)]


# ---- the structural check ---------------------------------------------------


class _Est(Estimator):
    def fit(self, data):
        return Transformer.from_function(lambda x: x)


def _structural_cases(pkg):
    """name -> (graph, rules the check reports), built the same way in
    both packages."""
    w = pkg[0]
    est_cls = _Est if pkg is PACKAGES["port"] else _JaxEst
    cases = {}
    g, s, a, b, k = build_chain(pkg)
    cases["clean"] = g
    # a cycle a -> b -> a, made by rewiring a's dependency
    cases["cycle"] = g.set_dependencies(a, [b])
    # a delegate with only its transformer input
    g2 = w.Graph()
    g2, s2 = g2.add_source()
    g2, data = g2.add_node(w.DatasetOperator(np.zeros((2, 2))), [])
    g2, est = g2.add_node(est_cls(), [data])
    g2, dlg = g2.add_node(w.DelegatingOperator(), [est])
    g2, _ = g2.add_sink(dlg)
    cases["delegate_arity"] = g2
    # a delegate whose first input is data, not a fit
    g3 = w.Graph()
    g3, s3 = g3.add_source()
    g3, data = g3.add_node(w.DatasetOperator(np.zeros((2, 2))), [])
    g3, dlg = g3.add_node(w.DelegatingOperator(), [data, s3])
    g3, _ = g3.add_sink(dlg)
    cases["inverted_delegate"] = g3
    # an estimator's output read as data by a transformer
    g4 = w.Graph()
    g4, s4 = g4.add_source()
    g4, data = g4.add_node(w.DatasetOperator(np.zeros((2, 2))), [])
    g4, est = g4.add_node(est_cls(), [data])
    g4, bad = g4.add_node(op(pkg), [est])
    g4, _ = g4.add_sink(bad)
    cases["fit_before_use"] = g4
    # a transformer with no input, and a source nobody reads
    g5 = w.Graph()
    g5, s5 = g5.add_source()
    g5, lone = g5.add_node(op(pkg), [])
    g5, _ = g5.add_sink(lone)
    cases["arity_and_dangling"] = g5
    return cases


class _JaxEst(jax_workflow.Estimator):
    def fit(self, data):
        return JaxTransformer.from_function(lambda x: x)


@pytest.mark.parametrize("case", ["clean", "cycle", "delegate_arity",
                                  "inverted_delegate", "fit_before_use",
                                  "arity_and_dangling"])
def test_structural_check_matches_jax(case):
    port = structural_report(_structural_cases(PACKAGES["port"])[case])
    ref = jax_structural_report(_structural_cases(PACKAGES["jax"])[case])

    def verdicts(report):
        return sorted((d.rule, d.severity.name, str(d.vertex))
                      for d in report.diagnostics)

    assert verdicts(port) == verdicts(ref)
    assert port.ok == ref.ok == (case == "clean")


def test_executor_runs_the_structural_check_before_any_force():
    g = _structural_cases(PACKAGES["port"])["fit_before_use"]
    sink = next(iter(g.sink_ids))
    ex = GraphExecutor(g, optimize=False)
    with pytest.raises(PipelineValidationError) as info:
        ex.execute(sink)
    assert isinstance(info.value, ValueError)
    assert info.value.report.by_rule("KP003")
    # a retry fails the same way
    with pytest.raises(PipelineValidationError):
        ex.execute(sink)


# ---- expressions and operators -----------------------------------------------


def test_expression_forces_once_and_releases_its_thunk():
    calls = []
    e = Expression(lambda: calls.append(1) or 7)
    assert not e.is_forced
    assert e.get == 7 and e.get == 7 and calls == [1]
    assert e.is_forced and e._thunk is None
    assert Expression.of(3).is_forced and Expression.of(3).get == 3


def test_operators_dispatch_on_expression_kind():
    double = Transformer.from_function(lambda x: x * 2)
    ds = Dataset(torch.arange(4.0).reshape(4, 1), device="cpu")
    out = double.execute([DatasetExpression.of(ds)])
    assert isinstance(out, DatasetExpression) and not out.is_forced
    assert out.get.array.flatten().tolist() == [0.0, 2.0, 4.0, 6.0]
    one = double.execute([DatumExpression.of(torch.tensor(3.0))])
    assert isinstance(one, DatumExpression) and float(one.get) == 6.0
    with pytest.raises(ValueError):
        double.execute([DatasetExpression.of(ds),
                        DatumExpression.of(torch.tensor(1.0))])
    with pytest.raises(ValueError):
        double.execute([])
    fitted = TransformerExpression.of(double)
    dlg = DelegatingOperator().execute([fitted, DatumExpression.of(
        torch.tensor(2.0))])
    assert float(dlg.get) == 4.0
    with pytest.raises(ValueError):
        DelegatingOperator().execute([DatasetExpression.of(ds),
                                      DatasetExpression.of(ds)])
    with pytest.raises(ValueError):
        DelegatingOperator().execute([fitted])
    saved = ExpressionOperator(fitted, name="x")
    assert saved.execute([]) is fitted and saved.label == "Saved[x]"
    gathered = GatherTransformerOperator().execute(
        [DatasetExpression.of(ds), DatasetExpression.of(ds)]).get
    assert len(gathered.data) == 2 and gathered.count == 4
    assert DatasetOperator(ds).execute([]).get is ds


def test_fitted_elem_fn_runs_the_single_item_path_on_meta_tensors():
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler

    elem = torch.empty((4, 5, 3), dtype=torch.uint8, device="meta")
    scaled = fitted_elem_fn(PixelScaler())(elem)
    assert scaled.shape == (4, 5, 3) and scaled.dtype == torch.float32
    assert scaled.device.type == "meta"
    gray = fitted_elem_fn(GrayScaler())(scaled)
    assert gray.shape == (4, 5, 1)


def test_prefix_keys_and_identity():
    from keystone_tpu_torch.workflow.env import IdentityKey

    a, b = [1], [1]
    assert IdentityKey(a) == IdentityKey(a) and IdentityKey(a) != IdentityKey(b)
    assert hash(IdentityKey(a)) == id(a)
    ds = Dataset(torch.zeros(2, 2), device="cpu")
    assert DatasetOperator(ds).prefix_key() == DatasetOperator(ds).prefix_key()
    t = Transformer.from_function(lambda x: x)
    assert t.prefix_key() != Transformer.from_function(lambda x: x
                                                        ).prefix_key()


# ---- the pickle format -------------------------------------------------------


def test_pickle_writes_cpu_tensors_and_places_them_on_load(tmp_path):
    path = str(tmp_path / "x.pkl")
    obj = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.tensor(True),
           "h": torch.ones(2, dtype=torch.bfloat16), "e": torch.zeros(0, 3),
           "dev": torch.device("cpu"), "n": np.arange(3)}
    save_pytree_pickle(obj, path)
    with open(path, "rb") as f:
        raw = f.read()
    with pytest.raises(pickle.UnpicklingError):
        pickle.loads(raw)  # tensors are persistent ids, not torch pickles
    back = load_pytree_pickle(path, torch.device("cpu"))
    for key in ("w", "b", "h", "e"):
        assert torch.equal(back[key], obj[key])
        assert back[key].dtype == obj[key].dtype
    assert back["dev"] == torch.device("cpu")
    np.testing.assert_array_equal(back["n"], obj["n"])


def test_save_names_the_part_that_cannot_be_pickled(tmp_path):
    path = tmp_path / "x.pkl"
    good = Transformer.from_function(abs, name="ok")
    bad = Transformer.from_function(lambda x: x, name="my-lambda")
    with pytest.raises(TypeError, match="my-lambda"):
        save_pytree_pickle([good, bad], str(path), parts=[good, bad])
    assert not path.exists()
