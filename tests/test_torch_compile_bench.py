"""`keystone_tpu_torch/compile_bench.py` on the CPU.

Mirrors `tests/test_compile.py:218-245` (a rebuilt example's second run
compiles nothing, at the full and at a ragged held-out count, and its
outputs equal the first's) and `tests/test_megafusion.py:383` (the
megafused warm run is one program an apply). JAX's gates count XLA
compiles against its persistent cache; the port's count what
`telemetry/compile_events.py` records: library builds (none after the
first build in a process) and CUDA graph captures (none on the CPU).
The predictions equal JAX's on the same numpy arrays; each run calls its
fitted chain twice at one shape, which on the card is a capture. The
host-chunk
workload runs a fused chain's `run_rung` through `map_host_batched`:
padded, every chunk has the chunk's rows; ragged, the tail is a second
shape, which on the card is a second graph.
"""

import numpy as np
import pytest
import torch

import jax

from keystone_tpu import compile_bench as jax_compile_bench
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu_torch import compile_bench
from keystone_tpu_torch.telemetry.compile_events import (
    compiles_by_kind,
    record_compile,
)
from keystone_tpu_torch.workflow import PipelineEnv

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.mark.parametrize("ragged", [False, True], ids=["multiple", "ragged"])
def test_second_run_performs_zero_cold_compiles(ragged):
    rep = compile_bench.measure_example_compiles(
        "TimitPipeline", ragged_test=ragged, device=CPU)
    assert rep["warm_programs_compiled"] == 0, rep
    assert rep["warm_captures_le_cold"], rep
    assert rep["apply_compiles_le_plan_programs"], rep
    assert rep["outputs_match_cold"]
    assert rep["ragged_test"] is ragged


def test_megafused_warm_run_is_one_program():
    rep = compile_bench.measure_example_compiles("MnistRandomFFT",
                                                 device=CPU)
    assert rep["plan"] == "megafused"
    assert rep["warm_programs_compiled"] == 0
    assert rep["warm_run"]["apply_programs_executed"] == 1
    for side in ("cold_run", "warm_run"):
        assert set(rep[side]["compiles"]) >= {
            "programs_compiled", "compile_cache_hits", "library_builds",
            "graph_captures"}


@pytest.mark.parametrize("ragged", [False, True], ids=["multiple", "ragged"])
def test_runs_predict_what_jax_predicts(ragged):
    """Both runs' predictions equal JAX's on the same arrays (the ragged
    count is JAX's on one device: two rows fewer)."""
    got = compile_bench._run_example("TimitPipeline", ragged, "megafused",
                                     CPU)
    with use_mesh(make_mesh(jax.devices()[:1])):
        want = jax_compile_bench._run_example("TimitPipeline", ragged)
    np.testing.assert_array_equal(got["train_pred"], want["train_pred"])
    np.testing.assert_array_equal(got["test_pred"], want["test_pred"])
    assert got["apply_programs_executed"] == want["apply_programs_executed"]


@pytest.mark.parametrize("name", ["MnistRandomFFT", "TimitPipeline"])
def test_each_run_calls_one_chain_twice_at_one_shape(name, monkeypatch):
    """A run's fitted pipeline calls its megafused chain twice at the
    held-out rows' shape: on the card the first call runs eagerly and
    the second captures, so the cold run's captures are not 0 there."""
    from keystone_tpu_torch.nodes.util.fusion import FusedBatchTransformer

    calls = []
    real = FusedBatchTransformer.run_rung

    def run_rung(self, x, rows, trip):
        calls.append((id(self), tuple(x.shape), rows, trip))
        return real(self, x, rows, trip)

    monkeypatch.setattr(FusedBatchTransformer, "run_rung", run_rung)
    compile_bench._run_example(name, False, "megafused", CPU)
    assert max(calls.count(c) for c in calls) >= 2, calls


def test_host_chunk_padding_keys_one_shape():
    rep = compile_bench.measure_host_chunk_compiles(device=CPU)
    assert (rep["n_items"], rep["chunk"]) == (43, 16)
    assert rep["padded_chunk_shapes"] == 1
    assert rep["ragged_chunk_shapes"] == 2
    assert rep["measured_by"] == "chunk_shapes"
    assert rep["padded_graph_captures"] == rep["ragged_graph_captures"] == 0
    assert rep["outputs_identical"]


def test_report_gates_hold_on_the_cpu():
    rep = compile_bench.compile_count_report(("MnistRandomFFT",),
                                             device=CPU)
    assert rep["all_warm_runs_zero_compiles"]
    assert rep["all_warm_captures_le_cold"]
    assert rep["all_apply_compiles_bounded"]
    assert rep["host_tail_padding_saves_programs"]
    assert [r["plan"] for r in rep["plan_breakdown"]] == [
        "megafused", "optimized", "precision"]
    assert rep["plan_breakdown"][0]["warm_apply_programs_executed"] == 1


def test_compiles_split_by_kind():
    before = compiles_by_kind()
    record_compile("lib", 0.1, cold=True, kind="kernel")
    record_compile("chain", 0.01, cold=True, kind="graph")
    record_compile("lib", 0.001, cold=False, kind="kernel")
    after = compiles_by_kind()
    assert after["kernel"] - before["kernel"] == 1
    assert after["graph"] - before["graph"] == 1
    assert after["host"] == before["host"]
