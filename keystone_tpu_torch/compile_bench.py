"""Compile accounting for the example pipelines: what a run compiles,
cold against warm.

Counterpart of `keystone_tpu/compile_bench.py:1-243`. On the card a
compile is what `telemetry/compile_events.py` records: a library built
from ``csrc/`` by `ops/_build.py` (kind ``kernel`` or ``host``) or a
CUDA graph captured by a fused chain (kind ``graph``). There is no
persistent compilation cache (JAX's ``compile_cache_dir`` is not ported):
within one process the warm cache is the set of libraries `ops/_build.py`
has loaded.

`measure_example_compiles` runs an example of `dispatch_bench.EXAMPLES`
twice in one process, each run on a pipeline rebuilt from scratch, and
keeps JAX's fields with the compiles split by kind:

  - ``warm_programs_compiled`` counts the warm run's library builds, and
    must be 0;
  - graph captures have columns of their own: graphs are kept by each
    `FusedBatchTransformer` (`nodes/util/fusion.py`), so a rebuilt
    pipeline captures its graphs again, and the warm run may capture no
    more than the cold run (``warm_captures_le_cold``);
  - ``warm_beats_cold`` is reported, and gated on by nobody.

A run then applies its held-out rows twice more, through its fitted
pipeline (`Pipeline.fit`; each call of the unfitted pipeline plans its
chains anew, so none is called twice): the first apply runs the chain
eagerly and the second captures its graph, so on the card each
megafused run captures (``cold_runs_capture``) and the warm run's
captures are compared with real counts. Its apply fields
(``apply_programs_executed``, ``apply_compiles``) are the first apply's,
JAX's window.
`measure_graph_recapture` shows what a rebuilt pipeline pays on a
repeated apply: its graph captured again, once a build
(``recapture_once_per_build``: [1, 1] on the card, [0, 0] on the CPU).

Outputs of the two runs must agree within 1e-5. `measure_host_chunk_compiles`
(JAX's `:147-181` uses ``jax.jit``) runs a fused chain's `run_rung` over
43 host items in chunks of 16 through `utils/batching.py::map_host_batched`,
with ``pad_chunks`` on and off, twice each: padded, every chunk has the
chunk's rows and one graph serves them; ragged, the tail's 11 rows are a
second shape and a second graph. The graphs exist only on the card, so
the report also gives the distinct chunk shapes each plan ran (1 and 2),
which is what the verdict reads on the CPU.

    python -m keystone_tpu_torch.compile_bench [--device cpu] [NAME ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Tuple

import numpy as np

from .device import DeviceLike, resolve_device
from .dispatch_bench import EXAMPLES
from .workflow.pipeline import Transformer


def _snapshot() -> Dict:
    """The compile counters, after the warm-ups in flight have finished
    (a straggler from the cold run must not land in the warm run's
    window): JAX's fields, plus the library builds and graph captures."""
    from .telemetry.compile_events import compiles_by_kind, compiles_snapshot
    from .workflow.executor import drain_warmups

    drain_warmups()
    snap = dict(compiles_snapshot())
    kinds = compiles_by_kind()
    snap["library_builds"] = kinds["kernel"] + kinds["host"]
    snap["graph_captures"] = kinds["graph"]
    return snap


def _delta(before: Dict, after: Dict) -> Dict:
    return {k: round(after[k] - before[k], 4) for k in before}


def _run_example(name: str, ragged_test: bool, plan: str, device):
    """One run on a freshly built pipeline in a fresh `PipelineEnv`
    (`:53-105`): its seconds, its compiles and its apply's, the apply's
    programs, and both predictions on the host. ``ragged_test`` drops
    the held-out set's last two rows, JAX's count on one device."""
    from .data.dataset import Dataset
    from .dispatch_bench import _plan_context
    from .telemetry import metrics_delta
    from .workflow.env import PipelineEnv, config_override

    optimizer, _, _, overrides = _plan_context(plan)
    PipelineEnv.reset()
    try:
        with config_override(**overrides):
            PipelineEnv.get().set_optimizer(optimizer)
            predictor, train, test = EXAMPLES[name](device)
            if ragged_test:
                test = Dataset(test.data, count=test.count - 2)
            t0 = time.perf_counter()
            before = _snapshot()
            train_pred = predictor(train).get().numpy()
            mid = _snapshot()
            with metrics_delta() as d_apply:
                test_pred = predictor(test).get().numpy()
            apply_programs = int(d_apply.counter(
                "dispatch.programs_executed"))
            applied = _snapshot()
            # each call of ``predictor`` plans its chains anew, and a
            # fitted pipeline keeps them: its first apply runs a chain
            # eagerly, its second captures the chain's graph
            fitted = predictor.fit()
            for _ in range(2):
                np.testing.assert_allclose(
                    fitted.apply(test).numpy(), test_pred, rtol=1e-5,
                    atol=1e-5)
            seconds = time.perf_counter() - t0
            after = _snapshot()
            return {
                "plan": plan,
                "seconds": round(seconds, 4),
                "compiles": _delta(before, after),
                "apply_compiles": _delta(mid, applied),
                "apply_programs_executed": apply_programs,
                "train_pred": np.asarray(train_pred),
                "test_pred": np.asarray(test_pred),
            }
    finally:
        PipelineEnv.reset()


def measure_example_compiles(name: str, ragged_test: bool = False,
                             plan: str = "megafused",
                             device: DeviceLike = "cuda") -> Dict:
    """A cold run against a warm one of one example (`:108-144`), each on
    a pipeline rebuilt from scratch. Raises where the two runs' outputs
    differ by more than 1e-5."""
    device = resolve_device(device)
    cold = _run_example(name, ragged_test, plan, device)
    warm = _run_example(name, ragged_test, plan, device)
    np.testing.assert_allclose(
        warm["train_pred"], cold["train_pred"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        warm["test_pred"], cold["test_pred"], rtol=1e-5, atol=1e-5)
    keys = ("seconds", "compiles", "apply_compiles",
            "apply_programs_executed")
    return {
        "example": name,
        "plan": plan,
        "ragged_test": ragged_test,
        "cold_run": {k: cold[k] for k in keys},
        "warm_run": {k: warm[k] for k in keys},
        "warm_beats_cold": bool(warm["seconds"] < cold["seconds"]),
        "warm_programs_compiled": int(warm["compiles"]["library_builds"]),
        "warm_graph_captures": int(warm["compiles"]["graph_captures"]),
        "cold_graph_captures": int(cold["compiles"]["graph_captures"]),
        "warm_captures_le_cold": bool(
            warm["compiles"]["graph_captures"]
            <= cold["compiles"]["graph_captures"]),
        # the warm apply, the serving path, compiles at most one program
        # for each program it runs
        "apply_compiles_le_plan_programs": bool(
            warm["apply_compiles"]["programs_compiled"]
            <= warm["apply_programs_executed"]),
        "outputs_match_cold": True,  # asserted above; raises otherwise
    }


def measure_graph_recapture(name: str = "MnistRandomFFT", applies: int = 3,
                            device: DeviceLike = "cuda") -> Dict:
    """Graphs are kept by the transformer that captured them: an example
    built twice, each build fit (`Pipeline.fit`) and its fitted pipeline
    applied ``applies`` times to the held-out rows, captures its apply's
    graph once per build (at the second apply; the first runs eagerly). ``captures_per_build``
    lists each build's captures; on the CPU nothing is captured."""
    from .dispatch_bench import _plan_context
    from .workflow.env import PipelineEnv, config_override

    device = resolve_device(device)
    optimizer, _, _, overrides = _plan_context("megafused")
    captures = []
    for _ in range(2):
        PipelineEnv.reset()
        try:
            with config_override(**overrides):
                PipelineEnv.get().set_optimizer(optimizer)
                predictor, _, test = EXAMPLES[name](device)
                fitted = predictor.fit()
                before = _snapshot()
                for _ in range(applies):
                    fitted.apply(test)
                captures.append(int(_delta(before, _snapshot())[
                    "graph_captures"]))
        finally:
            PipelineEnv.reset()
    return {"example": name, "applies": applies,
            "captures_per_build": captures,
            "recapture_once_per_build": captures == [
                1 if device.type == "cuda" else 0] * 2}


class _Affine(Transformer):
    """``x * 2 + 1``: the host-chunk workload's one stage."""

    fusable = True
    chunkable = True

    def batch_fn(self):
        return lambda xb: xb * 2.0 + 1.0

    def fuse(self):
        return ("HostChunkAffine",), ()


def measure_host_chunk_compiles(n_items: int = 43, chunk: int = 16,
                                dim: int = 6, device: DeviceLike = "cuda"
                                ) -> Dict:
    """The ragged-tail workload (`:147-181`): ``n_items`` items of one
    shape through a fused chain's `run_rung`, ``chunk`` items a chunk,
    with the tail padded to the chunk and not, each plan run twice (a
    `run_rung` key runs eagerly at its first call and is captured at
    its second). Raises where the plans' outputs differ."""
    from .nodes.util.fusion import FusedBatchTransformer
    from .utils.batching import map_host_batched
    from .workflow.env import config_override

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    items = [rng.normal(size=(dim,)).astype(np.float32)
             for _ in range(n_items)]

    def run(pad: bool):
        chain = FusedBatchTransformer([_Affine()], microbatch=chunk)
        shapes = set()

        def batch_fn(rows):
            shapes.add(rows.shape[0])
            return chain.run_rung(rows, rows.shape[0], rows.shape[0])

        before = _snapshot()
        with config_override(pad_chunks=pad):
            for _ in range(2):
                out = map_host_batched(items, batch_fn, chunk=chunk,
                                       device=device)
        return out, _delta(before, _snapshot()), len(shapes)

    padded_out, padded, padded_shapes = run(True)
    ragged_out, ragged, ragged_shapes = run(False)
    for a, b in zip(padded_out, ragged_out):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6)
    on_card = device.type == "cuda"
    return {
        "n_items": n_items,
        "chunk": chunk,
        "padded_programs_compiled": int(padded["programs_compiled"]),
        "ragged_programs_compiled": int(ragged["programs_compiled"]),
        "padded_graph_captures": int(padded["graph_captures"]),
        "ragged_graph_captures": int(ragged["graph_captures"]),
        "padded_chunk_shapes": padded_shapes,
        "ragged_chunk_shapes": ragged_shapes,
        # graphs are the card's; on the CPU the shapes a graph would key
        "measured_by": "graph_captures" if on_card else "chunk_shapes",
        "outputs_identical": True,  # asserted above
    }


def compile_count_report(
    examples: Tuple[str, ...] = ("MnistRandomFFT", "TimitPipeline"),
    device: DeviceLike = "cuda",
) -> Dict:
    """Cold against warm compiles and seconds per example, at the full
    and at a ragged held-out count, the per-plan breakdown rows, and the
    host-chunk workload (`:184-243`). The gates: every warm run builds
    no library, captures no more graphs than its cold run and compiles
    at most a program for each it runs; on the card every cold run
    captures and a rebuilt pipeline recaptures once a build; the padded
    tail compiles less than the ragged one."""
    device = resolve_device(device)
    out: Dict = {"examples": {}, "plan": "megafused",
                 "plan_breakdown": []}

    def breakdown_row(name, rep):
        return {
            "example": name,
            "plan": rep["plan"],
            "warm_apply_programs_executed":
                rep["warm_run"]["apply_programs_executed"],
            "warm_apply_cold_compiles":
                rep["warm_run"]["apply_compiles"]["programs_compiled"],
        }

    for name in examples:
        out["examples"][name] = {
            "multiple": measure_example_compiles(name, False, device=device),
            "ragged": measure_example_compiles(name, True, device=device),
        }
        out["plan_breakdown"].append(
            breakdown_row(name, out["examples"][name]["multiple"]))
        for plan in ("optimized", "precision"):
            out["plan_breakdown"].append(breakdown_row(
                name, measure_example_compiles(name, False, plan=plan,
                                               device=device)))
    out["host_chunk"] = measure_host_chunk_compiles(device=device)
    out["recapture"] = measure_graph_recapture(device=device)
    runs = [r for e in out["examples"].values() for r in e.values()]
    out["examples_warm_zero_compiles"] = int(sum(
        1 for e in out["examples"].values()
        if all(r["warm_programs_compiled"] == 0 for r in e.values())))
    out["examples_warm_beats_cold"] = int(sum(
        1 for e in out["examples"].values()
        if all(r["warm_beats_cold"] for r in e.values())))
    out["all_warm_runs_zero_compiles"] = all(
        r["warm_programs_compiled"] == 0 for r in runs)
    out["all_warm_captures_le_cold"] = all(
        r["warm_captures_le_cold"] for r in runs)
    # the runs are megafused: on the card each captures its apply's graph
    out["cold_runs_capture"] = all(
        r["cold_graph_captures"] >= (1 if device.type == "cuda" else 0)
        for r in runs)
    out["all_warm_beats_cold"] = all(r["warm_beats_cold"] for r in runs)
    out["all_apply_compiles_bounded"] = all(
        r["apply_compiles_le_plan_programs"] for r in runs)
    hc = out["host_chunk"]
    if hc["measured_by"] == "graph_captures":
        saves = hc["padded_graph_captures"] < hc["ragged_graph_captures"]
    else:
        saves = hc["padded_chunk_shapes"] < hc["ragged_chunk_shapes"]
    out["host_tail_padding_saves_programs"] = bool(saves)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.compile_bench",
        description=__doc__.splitlines()[0])
    p.add_argument("examples", nargs="*", metavar="EXAMPLE",
                   help="examples (default: MnistRandomFFT TimitPipeline)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    names = tuple(args.examples or ("MnistRandomFFT", "TimitPipeline"))
    unknown = [n for n in names if n not in EXAMPLES]
    if unknown:
        p.error(f"unknown example(s): {', '.join(unknown)}")
    report = compile_count_report(names, device=args.device)
    json.dump(report, sys.stdout, indent=1, default=str)
    print()
    ok = (report["all_warm_runs_zero_compiles"]
          and report["all_warm_captures_le_cold"]
          and report["cold_runs_capture"]
          and report["recapture"]["recapture_once_per_build"]
          and report["all_apply_compiles_bounded"]
          and report["host_tail_padding_saves_programs"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
