"""`keystone_tpu_torch/dispatch_bench.py` on the CPU, held against
`keystone_tpu/dispatch_bench.py`.

Per example and plan, the port's predictions equal JAX's (the examples
draw the same numpy arrays; the argmax classes agree exactly), the
fit-run and apply-run program counts equal JAX's, and so do the
decisions the optimizer recorded, by kind. Both packages count a program
at the same sites, so no count differs: the ``kernel`` plan's self-tag
(ROADMAP queue 3) changes where the port's chain kernel runs, not the
programs it runs in. On the CPU no kernel launches, no graph replays and
nothing waits for a card, and the device columns say so.

Mirrors `tests/test_megafusion.py:325-380` (the kill switch, one program
an apply run, the report's breakdown rows), `tests/test_chain_kernels.py:
335-360` (the ``kernel`` plan's column and its warm rerun) and
`tests/test_scheduler.py:343, 423` (at least 2x fewer programs than the
serial and legacy plans; legacy's outputs equal serial's). The JAX side
runs on a one-device mesh (ROADMAP, ground rules).
"""

import numpy as np
import pytest
import torch

import jax

from keystone_tpu import dispatch_bench as jax_bench
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch import dispatch_bench as bench
from keystone_tpu_torch.telemetry import compiles_snapshot
from keystone_tpu_torch.workflow import PipelineEnv
from keystone_tpu_torch.workflow.executor import drain_warmups

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _jax(name, plan):
    with use_mesh(make_mesh(jax.devices()[:1])):
        return jax_bench.measure_example(name, plan)


def test_plans_and_examples_are_jax_s():
    assert bench.PLANS == jax_bench.PLANS
    assert list(bench.EXAMPLES) == list(jax_bench.EXAMPLES)


@pytest.mark.parametrize("plan", bench.PLANS)
@pytest.mark.parametrize("name", list(bench.EXAMPLES))
def test_measure_example_equals_jax(name, plan):
    got = bench.measure_example(name, plan, device=CPU)
    want = _jax(name, plan)
    np.testing.assert_array_equal(got["train_pred"], want["train_pred"])
    np.testing.assert_array_equal(got["test_pred"], want["test_pred"])
    assert got["fit_run_programs"] == want["fit_run_programs"]
    assert got["apply_run_programs"] == want["apply_run_programs"]
    assert bench._kind_counts(got["decisions"]) == \
        jax_bench._kind_counts(want["decisions"])
    for side in ("fit_run_device", "apply_run_device"):
        counts = got[side]
        assert counts["programs"] == got[side.replace("_device",
                                                      "_programs")]
        assert {k: v for k, v in counts.items() if k != "programs"} == {
            "graph_replays": 0, "syncs": 0, "conv_rectify_pool": 0,
            "elementwise_chain": 0, "rbf_block": 0}


def test_kill_switch_reverts_to_the_two_program_plan():
    mega = bench.measure_example("MnistRandomFFT", "megafused", device=CPU)
    opt = bench.measure_example("MnistRandomFFT", "optimized", device=CPU)
    assert mega["apply_run_programs"] == 1
    assert opt["apply_run_programs"] == 2
    np.testing.assert_allclose(mega["test_pred"], opt["test_pred"])
    np.testing.assert_allclose(mega["train_pred"], opt["train_pred"])


@pytest.mark.parametrize("example", ["MnistRandomFFT", "RandomPatchCifar"])
def test_one_program_per_apply_run(example):
    base = bench.measure_example(example, "serial_unfused", device=CPU)
    mega = bench.measure_example(example, "megafused", device=CPU)
    assert mega["apply_run_programs"] == 1
    assert mega["fit_run_programs"] <= base["fit_run_programs"]
    np.testing.assert_allclose(mega["train_pred"], base["train_pred"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mega["test_pred"], base["test_pred"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("example", ["RandomPatchCifar", "MnistRandomFFT"])
def test_dispatch_reduction_at_least_2x(example):
    base = bench.measure_example(example, "serial_unfused", device=CPU)
    legacy = bench.measure_example(example, "legacy", device=CPU)
    opt = bench.measure_example(example, "optimized", device=CPU)
    for ref in (base, legacy):
        assert ref["apply_run_programs"] / opt["apply_run_programs"] >= 2.0


def test_legacy_plan_matches_serial_outputs():
    base = bench.measure_example("RandomPatchCifar", "serial_unfused",
                                 device=CPU)
    legacy = bench.measure_example("RandomPatchCifar", "legacy", device=CPU)
    assert legacy["apply_run_programs"] <= base["apply_run_programs"]
    np.testing.assert_allclose(legacy["test_pred"], base["test_pred"],
                               rtol=1e-5, atol=1e-5)


def test_report_equals_jax_and_passes_its_gates():
    """The whole report over all four examples: JAX's fields equal, the
    three verdicts true, and the port's device columns added."""
    names = tuple(bench.EXAMPLES)
    got = bench.dispatch_count_report(names, device=CPU)
    with use_mesh(make_mesh(jax.devices()[:1])):
        want = jax_bench.dispatch_count_report(names)
    for key in ("plans", "plan_breakdown", "examples_at_or_above_2x",
                "examples_at_one_program", "top2_min_reduction",
                "all_outputs_match", "precision_in_band",
                "decisions_reconciled"):
        assert got[key] == want[key], key
    assert got["all_outputs_match"] and got["precision_in_band"] \
        and got["decisions_reconciled"]
    for name in names:
        g, w = got["examples"][name], want["examples"][name]
        for key in w:
            assert g[key] == w[key], (name, key)
        assert set(g["device"]) == set(bench.PLANS)


def test_bench_kernel_plan_column():
    assert "kernel" in bench.PLANS
    _, _, _, overrides = bench._plan_context("kernel")
    assert overrides["unified_planner"] is True
    assert overrides["unified_min_savings_seconds"] == 0.0
    # no switch picks a plain path: the port has no pallas_kernels field
    assert "pallas_kernels" not in overrides
    with pytest.raises(ValueError, match="unknown plan"):
        bench._plan_context("interpret")


def test_warm_kernel_run_zero_cold_compiles():
    r1 = bench.measure_example("LinearPixels", "kernel", device=CPU)
    assert r1["apply_run_programs"] >= 1
    drain_warmups()
    first = compiles_snapshot()
    r2 = bench.measure_example("LinearPixels", "kernel", device=CPU)
    drain_warmups()
    assert compiles_snapshot()["programs_compiled"] == \
        first["programs_compiled"]
    assert any(d.get("kind") == "kernel" for d in r2["decisions"])


def test_the_cli_prints_the_report(capsys):
    import json

    assert bench.main(["LinearPixels", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert list(report["examples"]) == ["LinearPixels"]
    assert report["decisions_reconciled"]
