"""The port's decision ledger (`telemetry/ledger.py`) on the CPU.

Mirrors `tests/test_ledger.py`: the JSONL round trip, independently
parseable lines, the ambient path, the ledger beside a trace, the trace
metadata form, `suppressed()`, a truncated tail, a mid-run config change,
``--diff`` naming a ``KEYSTONE_MEGAFUSION`` flip, seeded prediction
drift, a clean self-diff and the CLI's table. Its predicted-versus-
observed joins and the cost-model drift report wait for the analysis
tiers (ROADMAP queue 1, item 8).

Parity: a ledger the JAX package wrote reads, renders and diffs the
same through the port's `read_ledger`, `render_ledger`, `diff_runs` and
CLI. End to end: a fitted pipeline applied with megafusion on, then off,
records the port's fusion and megafusion decisions, and `diff_runs`
names the ``KEYSTONE_MEGAFUSION`` flip and the removed decision, as
JAX's `tests/test_ledger.py:388` does.
"""

import json

import numpy as np
import pytest
import torch

from keystone_tpu.telemetry import ledger as jax_ledger
from keystone_tpu.telemetry.__main__ import main as jax_cli
from keystone_tpu.workflow.env import config_override as jax_config_override
from keystone_tpu_torch.data.dataset import Dataset
from keystone_tpu_torch.nodes.learning import LinearMapEstimator
from keystone_tpu_torch.nodes.stats.normalization import NormalizeRows
from keystone_tpu_torch.nodes.stats.scalers import StandardScaler
from keystone_tpu_torch.telemetry import ledger, trace_run
from keystone_tpu_torch.telemetry.__main__ import main as telemetry_main
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.env import config_override

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_session():
    ledger.clear_session()
    jax_ledger.clear_session()
    yield
    ledger.clear_session()
    jax_ledger.clear_session()
    PipelineEnv.reset()


def _record_sample(kind="megafusion", labels=("Fused[A >> B]",),
                   predicted=None, module=ledger):
    return module.record_decision(
        kind=kind,
        rule="MegafusionRule" if kind == "megafusion" else "NodeFusionRule",
        vertices=[3, 4, 5],
        labels=list(labels),
        chosen={"entry": "megafused_scan_program", "programs": 1,
                "members": 3},
        alternatives=[{"entry": "per_stage_dispatch", "programs": 5,
                       "cost_programs": 5},
                      {"entry": "pairwise_fusion", "programs": 3,
                       "cost_programs": 3}],
        predicted=predicted or {"programs_per_apply": 1,
                                "programs_eliminated": 4,
                                "cold_compiles_max": 1},
    )


def test_ledger_round_trip_jsonl(tmp_path):
    rec = _record_sample()
    assert rec is not None and rec["enforced"]
    path = ledger.write_session(str(tmp_path / "run.ledger.jsonl"))
    run = ledger.read_ledger(path)
    header = run["header"]
    assert header["ledger_version"] == ledger.LEDGER_VERSION
    assert set(header["config"]) == set(ledger.CONFIG_ENV)
    assert header["config_env"]["megafusion"] == "KEYSTONE_MEGAFUSION"
    assert header["platform"] == "cpu"
    assert header["execution_config"]["megafusion"] is True
    (d,) = run["decisions"]
    assert d["kind"] == "megafusion" and d["seq"] == rec["seq"]
    ru = ledger.runner_up(d)
    assert ru["entry"] == "pairwise_fusion" and ru["cost_programs"] == 3
    table = ledger.render_ledger(run)
    assert "megafused_scan_program" in table and "pairwise_fusion" in table
    assert "1 decision(s)" in table


def test_ledger_jsonl_lines_are_independently_parseable(tmp_path):
    _record_sample()
    _record_sample(kind="fusion", labels=("A", "B"))
    path = ledger.write_session(str(tmp_path / "run.ledger.jsonl"))
    lines = [json.loads(line) for line in
             open(path).read().splitlines() if line.strip()]
    assert len(lines) == 3 and "ledger_version" in lines[0]
    assert [ln["seq"] for ln in lines[1:]] == [1, 2]


def test_ambient_jsonl_path_appends_incrementally(tmp_path):
    path = tmp_path / "ambient.ledger.jsonl"
    with config_override(ledger_path=str(path)):
        _record_sample()
        assert len(open(path).read().splitlines()) == 2
        _record_sample(kind="fusion", labels=("C",))
        assert len(open(path).read().splitlines()) == 3
    run = ledger.read_ledger(str(path))
    assert [d["kind"] for d in run["decisions"]] == ["megafusion", "fusion"]


def test_traced_run_defaults_ledger_alongside_trace(tmp_path):
    with config_override(trace_path=str(tmp_path / "run.json"),
                         ledger_path=None):
        assert ledger.resolve_ledger_path() == \
            str(tmp_path / "run.json") + ".ledger.jsonl"
    with config_override(trace_path=None, ledger_path=None):
        assert ledger.resolve_ledger_path() is None


def test_trace_metadata_form_loads(tmp_path):
    path = str(tmp_path / "run.json")
    with trace_run(path):
        _record_sample()
    run = ledger.read_ledger(path)
    assert run["trace"] is not None
    assert run["header"]["config"]["megafusion"] is True
    (d,) = run["decisions"]
    assert d["kind"] == "megafusion"


def test_suppressed_scope_records_nothing():
    with ledger.suppressed():
        assert _record_sample() is None
    assert ledger.session_decisions() == []


def test_truncated_tail_is_a_parseable_prefix(tmp_path):
    _record_sample()
    _record_sample(kind="fusion", labels=("A",))
    path = str(tmp_path / "killed.ledger.jsonl")
    ledger.write_session(path)
    with open(path, "a") as f:
        f.write('{"seq": 3, "kind": "fusi')
    run = ledger.read_ledger(path)
    assert [d["kind"] for d in run["decisions"]] == ["megafusion", "fusion"]
    lines = open(path).read().splitlines()
    lines[1] = lines[1][:20]
    (tmp_path / "corrupt.jsonl").write_text("\n".join(lines))
    with pytest.raises(ValueError):
        ledger.read_ledger(str(tmp_path / "corrupt.jsonl"))


def _write_run(tmp_path, name, megafusion=True, with_mega=True,
               predicted=None, module=ledger, override=config_override):
    module.clear_session()
    with override(megafusion=megafusion):
        _record_sample(kind="fusion", labels=("A", "B"), module=module)
        if with_mega:
            _record_sample(predicted=predicted, module=module)
        return module.write_session(str(tmp_path / name))


def test_mid_run_config_change_gets_its_own_header(tmp_path):
    path = tmp_path / "sweep.ledger.jsonl"
    with config_override(ledger_path=str(path)):
        with config_override(megafusion=False):
            _record_sample(kind="fusion", labels=("A",))
        _record_sample()
    run = ledger.read_ledger(str(path))
    assert len(run["headers"]) == 2
    assert run["headers"][0]["config"]["megafusion"] is False
    assert run["headers"][1]["config"]["megafusion"] is True
    b = _write_run(tmp_path, "b.jsonl", megafusion=True)
    assert ledger.diff_runs(run, ledger.read_ledger(b))["config_flips"] == []


def test_removed_decision_without_flip_names_no_suspect(tmp_path):
    a = _write_run(tmp_path, "a.jsonl", with_mega=True)
    b = _write_run(tmp_path, "b.jsonl", with_mega=False)
    diff = ledger.diff_runs(ledger.read_ledger(a), ledger.read_ledger(b))
    assert diff["config_flips"] == []
    (removed,) = diff["decisions_removed"]
    assert removed["kind"] == "megafusion" and removed["suspect_env"] is None


def test_diff_names_injected_megafusion_flip(tmp_path, capsys):
    a = _write_run(tmp_path, "a.jsonl", megafusion=True, with_mega=True)
    b = _write_run(tmp_path, "b.jsonl", megafusion=False, with_mega=False)
    diff = ledger.diff_runs(ledger.read_ledger(a), ledger.read_ledger(b))
    (flip,) = diff["config_flips"]
    assert flip["env"] == "KEYSTONE_MEGAFUSION"
    assert flip["a"] is True and flip["b"] is False
    (removed,) = diff["decisions_removed"]
    assert removed["suspect_env"] == "KEYSTONE_MEGAFUSION"
    assert telemetry_main(["--diff", a, b]) == 1
    out = capsys.readouterr().out
    assert "CONFIG FLIP: KEYSTONE_MEGAFUSION" in out
    assert "suspect: KEYSTONE_MEGAFUSION" in out


def test_diff_reports_seeded_prediction_drift(tmp_path, capsys):
    a = _write_run(tmp_path, "a.jsonl")
    b = _write_run(tmp_path, "b.jsonl",
                   predicted={"programs_per_apply": 1,
                              "programs_eliminated": 9,
                              "cold_compiles_max": 1})
    diff = ledger.diff_runs(ledger.read_ledger(a), ledger.read_ledger(b))
    (drift,) = diff["prediction_drift"]
    assert drift["metric"] == "programs_eliminated"
    assert drift["a"] == 4 and drift["b"] == 9
    assert telemetry_main(["--diff", a, b]) == 1
    assert "PREDICTION DRIFT" in capsys.readouterr().out


def test_diff_of_run_against_itself_is_clean(tmp_path, capsys):
    a = _write_run(tmp_path, "a.jsonl")
    assert ledger.diff_runs(ledger.read_ledger(a),
                            ledger.read_ledger(a))["regressions"] == 0
    assert telemetry_main(["--diff", a, a]) == 0
    assert "0 regression(s)" in capsys.readouterr().out


def test_ledger_cli_renders_table(tmp_path, capsys):
    a = _write_run(tmp_path, "a.jsonl")
    assert telemetry_main(["--ledger", a]) == 0
    out = capsys.readouterr().out
    assert "megafused_scan_program" in out and "runner-up" in out
    assert telemetry_main(["--ledger", a, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert [d["kind"] for d in payload["decisions"]] == ["fusion",
                                                         "megafusion"]


# ---- parity with a JAX-written ledger -------------------------------------


def _strip_path(run):
    return {k: v for k, v in run.items() if k != "path"}


def test_a_jax_ledger_reads_renders_and_diffs_the_same(tmp_path, capsys):
    a = _write_run(tmp_path, "a.jsonl", megafusion=True, module=jax_ledger,
                   override=jax_config_override)
    b = _write_run(tmp_path, "b.jsonl", megafusion=False, with_mega=False,
                   module=jax_ledger, override=jax_config_override)
    for path in (a, b):
        mine, theirs = ledger.read_ledger(path), jax_ledger.read_ledger(path)
        assert _strip_path(mine) == _strip_path(theirs)
        assert ledger.render_ledger(mine) == jax_ledger.render_ledger(theirs)
    diff = ledger.diff_runs(ledger.read_ledger(a), ledger.read_ledger(b))
    assert diff == jax_ledger.diff_runs(jax_ledger.read_ledger(a),
                                        jax_ledger.read_ledger(b))
    assert ledger.format_diff(diff) == jax_ledger.format_diff(diff)
    assert telemetry_main(["--diff", a, b]) == 1
    got = capsys.readouterr().out
    assert jax_cli(["--diff", a, b]) == 1
    assert got == capsys.readouterr().out
    assert telemetry_main(["--ledger", a]) == 0
    got = capsys.readouterr().out
    assert jax_cli(["--ledger", a]) == 0
    assert got == capsys.readouterr().out


def test_a_port_ledger_reads_the_same_through_jax(tmp_path):
    a = _write_run(tmp_path, "a.jsonl")
    assert _strip_path(jax_ledger.read_ledger(a)) == \
        _strip_path(ledger.read_ledger(a))


# ---- end to end: a fitted pipeline, megafusion on and off -----------------


def _fitted(X, Y):
    p = (NormalizeRows().to_pipeline()
         .and_then(StandardScaler(), X)
         .and_then(LinearMapEstimator(0.1), X, Y))
    return p.fit()


@pytest.mark.parametrize("traced", [False, True],
                         ids=["jsonl", "trace"])
def test_diff_default_vs_megafusion_off_names_the_flip(tmp_path, traced):
    rng = np.random.default_rng(0)
    X = Dataset(np.abs(rng.normal(size=(64, 6))).astype(np.float32) + 0.1,
                device=CPU)
    Y = Dataset(rng.normal(size=(64, 3)).astype(np.float32), device=CPU)
    paths, preds = {}, {}
    for mega in (True, False):
        PipelineEnv.reset()
        ledger.clear_session()
        path = str(tmp_path / f"mega_{int(mega)}.{'json' if traced else
                                                     'jsonl'}")
        if traced:
            with config_override(megafusion=mega), trace_run(path):
                preds[mega] = _fitted(X, Y).apply(X).numpy()
        else:
            with config_override(megafusion=mega, ledger_path=path):
                preds[mega] = _fitted(X, Y).apply(X).numpy()
        paths[mega] = path
    np.testing.assert_allclose(preds[True], preds[False], rtol=0,
                               atol=1e-5)
    run_on = ledger.read_ledger(paths[True])
    run_off = ledger.read_ledger(paths[False])
    assert {d["kind"] for d in run_on["decisions"]} >= {"fusion",
                                                        "megafusion"}
    assert "megafusion" not in {d["kind"] for d in run_off["decisions"]}
    diff = ledger.diff_runs(run_on, run_off)
    assert [f["env"] for f in diff["config_flips"]] == ["KEYSTONE_MEGAFUSION"]
    removed = [d for d in diff["decisions_removed"]
               if d["kind"] == "megafusion"]
    assert removed and removed[0]["suspect_env"] == "KEYSTONE_MEGAFUSION"
    assert "CONFIG FLIP: KEYSTONE_MEGAFUSION" in ledger.format_diff(diff)
