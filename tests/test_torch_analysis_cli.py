"""``python -m keystone_tpu_torch.analysis`` on the CPU, held against
``python -m keystone_tpu.analysis`` over the seven registered examples.

Each ported flag runs through both CLIs (in process; JAX on a one-device
mesh, the port with ``--device cpu``) with ``--json``. Both give the same
exit code, the same examples in the same order and, per example, the
same findings by rule and severity. Where the two price alike the JSON
is compared too:

- ``--explain-precision``: the planner's record equals JAX's but for the
  argmax boundary, int32 in JAX and int64 in torch (ROADMAP queue 3),
  which the bytes totals differ by and nothing else;
- ``--explain-roofline``: per stage the vertex, label, bytes and bound,
  the FLOPs within 5% (aten ops and jaxpr equations count a few apart),
  and the kernel candidates' vertices;
- ``--explain-sharding``: on one card every value is whole, so per stage
  the vertex, label, spec (JAX's on its one-device mesh) and boundary
  bytes (0), and the per-device bytes where both know them but for the
  argmax boundary (a 2x4 ``--mesh-shape`` is held to JAX's in
  `tests/test_torch_sharding_planner.py`);
- ``--certify-serving``: the verdicts (certified, unsuppressed errors,
  the suppressed rules), not the bounds: the port prices with its own
  machine rates;
- ``--explain-unified``: the verdicts and the decided kinds' presence,
  not the seconds: the port's chunk default (1024) and rates are its own;
- ``--audit-operators``: no finding in either registry;
- the default validation: the error and warning counts;
- ``--list-rules``: the port's rule ids are JAX's less the kernel-proof
  tier. ``--audit-kernels`` is not ported and argparse names it
  unknown.
"""

import contextlib
import io
import json

import pytest

import jax

from keystone_tpu.analysis.__main__ import main as jax_main
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch.analysis.__main__ import main as port_main
from keystone_tpu_torch.analysis.examples import EXAMPLES
from keystone_tpu_torch.workflow import PipelineEnv

#: relative FLOP gap allowed between aten and jaxpr counting
FLOP_RTOL = 0.05


@pytest.fixture(autouse=True)
def _clean():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _both(argv):
    """(port rc, port output, JAX rc, JAX output) of one flag."""
    with use_mesh(make_mesh(jax.devices()[:1])):
        jrc, jout = _run(jax_main, argv)
    prc, pout = _run(port_main, argv + ["--device", "cpu"])
    return prc, pout, jrc, jout


def _rules(record):
    found = record.get("findings", record.get("diagnostics", []))
    return sorted((f["rule"], f["severity"]) for f in found)


def _json_both(flag):
    argv = ([flag] if flag else []) + ["--json"]
    prc, pout, jrc, jout = _both(argv)
    got, want = json.loads(pout), json.loads(jout)
    assert prc == jrc
    assert [e["example"] for e in got["examples"]] == \
        [e["example"] for e in want["examples"]] == sorted(EXAMPLES)
    for g, w in zip(got["examples"], want["examples"]):
        assert "build_error" not in g, g
        assert _rules(g) == _rules(w), g["example"]
    return got, want


def _argmax(row) -> bool:
    return row.get("label") == "MaxClassifier"


def test_validation_equals_jax_s():
    got, want = _json_both(None)
    for g, w in zip(got["examples"], want["examples"]):
        assert (g["errors"], g["warnings"]) == (w["errors"], w["warnings"])


def test_explain_precision_equals_jax_s():
    got, want = _json_both("--explain-precision")
    for g, w in zip(got["examples"], want["examples"]):
        gp, wp = g["planner"], w["planner"]
        assert (gp is None) == (wp is None), g["example"]
        if gp is None:
            continue
        for key in ("savings_bytes", "improved", "changed_stages"):
            assert gp[key] == wp[key], (g["example"], key)
        int_rows = [(a, b) for a, b in zip(gp["stages"], wp["stages"])
                    if (a["dtype"], b["dtype"]) == ("int64", "int32")]
        widened = sum(a["default_bytes"] - b["default_bytes"]
                      for a, b in int_rows)
        assert gp["default_cost_bytes"] - wp["default_cost_bytes"] == widened
        assert gp["planned_cost_bytes"] - wp["planned_cost_bytes"] == widened
        for a, b in zip(gp["stages"], wp["stages"]):
            if (a, b) in int_rows:
                assert a["default_bytes"] == 2 * b["default_bytes"]
                continue
            assert a == b, g["example"]


def test_explain_roofline_prices_as_jax_s():
    got, want = _json_both("--explain-roofline")
    assert got["machine"]["balance"] > 0
    candidates = 0
    for g, w in zip(got["examples"], want["examples"]):
        assert len(g["stages"]) == len(w["stages"])
        for a, b in zip(g["stages"], w["stages"]):
            for key in ("vertex", "label", "hbm_bytes", "bound"):
                if _argmax(a) and key == "hbm_bytes":
                    continue
                assert a[key] == b[key], (g["example"], key)
            # aten ops and jaxpr equations count a few FLOPs apart
            # (`tests/test_torch_analysis_tiers.py`'s FLOP_RTOL)
            assert a["flops"] == pytest.approx(b["flops"], rel=FLOP_RTOL)
        assert [c["vertices"] for c in g["candidates"]] == \
            [c["vertices"] for c in w["candidates"]]
        candidates += len(g["candidates"])
    assert candidates >= 1


def test_explain_sharding_is_whole_value_placement():
    got, want = _json_both("--explain-sharding")
    assert got["devices"] == want["devices"] == 1
    for g, w in zip(got["examples"], want["examples"]):
        assert g["devices"] == 1
        assert [(s["vertex"], s["label"]) for s in g["stages"]] == \
            [(s["vertex"], s["label"]) for s in w["stages"]]
        for a, b in zip(g["stages"], w["stages"]):
            assert a["spec"] == b["spec"] and a["boundary_bytes"] == 0
            assert b["boundary_bytes"] == 0
            if b["per_device_bytes"] is not None and not _argmax(a):
                assert a["per_device_bytes"] == b["per_device_bytes"]
    prc, pout, jrc, jout = _both(["--explain-sharding", "--plan", "--json"])
    assert prc == jrc == 0
    assert all(e["planner"] is None for e in json.loads(pout)["examples"])
    assert all(e["planner"] is None for e in json.loads(jout)["examples"])


def test_certify_serving_verdicts_equal_jax_s():
    got, want = _json_both("--certify-serving")
    assert got["envelope"] == want["envelope"]
    for g, w in zip(got["examples"], want["examples"]):
        for key in ("certified", "unsuppressed_errors"):
            assert g[key] == w[key], (g["example"], key)
        # the same rules suppressed; the rationale names the port's fix
        assert set(g["suppressions"]) == set(w["suppressions"])
        assert [s["batch"] for s in g["certificate"]["shapes"]] == \
            [s["batch"] for s in w["certificate"]["shapes"]]


def test_explain_unified_verdicts_equal_jax_s():
    got, want = _json_both("--explain-unified")
    for g, w in zip(got["examples"], want["examples"]):
        gp, wp = g["planner"], w["planner"]
        assert (gp is None) == (wp is None), g["example"]
        if gp is not None:
            assert gp["joint_seconds"] <= gp["sequential_seconds"]
            assert ("kernel" in gp["changed_kinds"]) == \
                ("kernel" in wp["changed_kinds"]), g["example"]


def test_audit_operators_finds_nothing_in_either_registry():
    prc, pout, jrc, jout = _both(["--audit-operators", "--json"])
    assert prc == jrc == 0
    got, want = json.loads(pout), json.loads(jout)
    assert got["findings"] == want["findings"] == []
    assert got["audited_classes"] > 80 and got["probed_classes"] > 40


def test_list_rules_is_jax_s_less_the_unported_tiers():
    prc, pout, jrc, jout = _both(["--list-rules"])
    assert prc == jrc == 0
    got = {line.split()[0]: line for line in pout.splitlines() if line}
    want = {line.split()[0]: line for line in jout.splitlines() if line}
    assert set(got) <= set(want)
    assert {r for r in set(want) - set(got)} == {
        r for r in want if r.startswith("KP10") and len(r) == 6}
    for rule in ("KP501", "KP502", "KP503", "KP504"):
        assert got[rule] == want[rule]


def test_text_forms_mark_the_same_examples():
    """The text rendering's per-example verdict marks equal JAX's."""
    for flag in ("--explain-precision", "--explain-roofline"):
        prc, pout, jrc, jout = _both([flag])
        assert prc == jrc

        def marks(text):
            return [line.split(":")[0] for line in text.splitlines()
                    if line[:1] in ("✓", "✗")]

        assert marks(pout) == marks(jout)


def test_unknown_flags_and_examples():
    with pytest.raises(SystemExit):
        _run(port_main, ["--audit-kernels"])
    rc, _ = _run(port_main, ["--explain-roofline", "NoSuchExample",
                             "--device", "cpu"])
    assert rc == 2
