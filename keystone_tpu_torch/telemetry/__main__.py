"""Trace summary and decision ledger CLI.

Counterpart of `keystone_tpu/telemetry/__main__.py:1-293`:

    python -m keystone_tpu_torch.telemetry run.json [--top N] [--json]
    python -m keystone_tpu_torch.telemetry --ledger <run> [--json]
    python -m keystone_tpu_torch.telemetry --ledger <run> --emit-calibration <path>
    python -m keystone_tpu_torch.telemetry --diff <run_a> <run_b> [--json]
    python -m keystone_tpu_torch.telemetry --flight <dump> [--top N] [--json]
    python -m keystone_tpu_torch.telemetry --live [--json]

The trace form prints the span digest (top nodes by self-time, solver
steps and stream chunks), overlap queue stalls, the dispatch and compile
counts, the decisions and the reconciliations (`analysis/reconcile.py`:
static memory, roofline seconds and serving bounds against the run);
``--json`` adds the memory reconciliation to the digest. ``--ledger``
renders a run's decision ledger (a ``KEYSTONE_LEDGER`` JSONL file, or a
trace whose metadata embeds the decisions): one row per decision, chosen
entry, best-priced runner-up, prediction, and, where the run's trace is
reachable, what the run observed and the residual, then the run-level
join and the cost-model drift table. ``--emit-calibration <path>`` (with
``--ledger``) writes the drift-implied weights in the schema of
`nodes/learning/cuda_calibration.json`; ``KEYSTONE_COST_CALIBRATION=
<path>`` then prices with them (on the card the file names). A card's
run must have been traced with ``trace_run(path, synchronize=True)``,
whose node spans wait for the card; the command refuses another. ``--diff``
compares two runs' ledgers and their reconciliations and names config
flips by environment variable (``KEYSTONE_MEGAFUSION``); it exits 1 on
any regression. ``--flight`` renders a flight-recorder dump; ``--live``
this process's live health view.

Both packages write one trace and ledger format, so either CLI reads
either package's files.
"""

from __future__ import annotations

import argparse
import json
import sys

from .export import aggregate_spans, load_trace, summarize


def _read_run(path: str):
    from .ledger import read_ledger

    try:
        return read_ledger(path)
    except (OSError, ValueError) as e:
        print(f"error: {path}: {e}", file=sys.stderr)
        return None


def _reconcile(run):
    """The run's decision reconciliation (`:75-84`), or None where its
    trace is not reachable."""
    if not run.get("trace"):
        return None
    try:
        from ..analysis.reconcile import reconcile_decisions

        return reconcile_decisions(run)
    except Exception:
        return None


def _emit_calibration(run, out_path: str, ledger_path: str) -> int:
    """Write the run's drift-implied `CostWeights` in the schema of
    `cuda_calibration.json` (`:86-116`). The provenance names the
    platform the run's header recorded: weights a card's run implies
    stay the card's wherever the file is written. A card's run must
    have been traced with synchronized node spans (``trace_run(...,
    synchronize=True)``): its other spans time the host's enqueue, not
    the card, and their weights would price the card's stages too
    fast. The CPU runs synchronously, so any trace of a CPU run will
    do."""
    if not run.get("trace"):
        print("error: --emit-calibration needs a run whose trace "
              "artifact is reachable (the drift report is computed "
              "from observed span timings)", file=sys.stderr)
        return 2
    from ..analysis.reconcile import drift_cost_weights
    from ..nodes.learning.calibrate import write_calibration
    from ..nodes.learning.cost_model import live_platform

    run_platform = (run.get("header") or {}).get("platform")
    synchronized = bool((run["trace"].get("keystone") or {}).get(
        "node_spans_synchronized"))
    if (run_platform or live_platform()) != "cpu" and not synchronized:
        print("error: --emit-calibration needs a card's run traced with "
              "synchronized node spans (trace_run(path, "
              "synchronize=True)); this trace's node spans time the "
              "host's enqueue, not the card", file=sys.stderr)
        return 2
    weights = drift_cost_weights(run["trace"])
    provenance = {"source": "drift_cost_weights", "ledger": ledger_path,
                  "node_spans_synchronized": synchronized}
    assumed = ""
    if run_platform:
        provenance["platform"] = run_platform
    else:
        assumed = (" [platform assumed from THIS host — the run's "
                   "ledger predates the header platform field]")
    payload = write_calibration(out_path, weights, provenance=provenance)
    print(f"wrote {out_path}: cpu_weight={payload['cpu_weight']:.3e} "
          f"mem_weight={payload['mem_weight']:.3e} "
          f"(platform={payload['provenance'].get('platform')}{assumed}); "
          "point KEYSTONE_COST_CALIBRATION at it to recalibrate "
          "machine_rates()")
    return 0


def _ledger_main(path: str, as_json: bool,
                 emit_calibration: str = None) -> int:
    from .ledger import render_ledger

    run = _read_run(path)
    if run is None:
        return 2
    if emit_calibration:
        return _emit_calibration(run, emit_calibration, path)
    rec = _reconcile(run)
    drift = None
    if run.get("trace"):
        try:
            from ..analysis.reconcile import cost_model_drift

            drift = cost_model_drift(run["trace"])
        except Exception:
            drift = None
    if as_json:
        json.dump({
            "header": run["header"],
            "decisions": run["decisions"],
            "reconciliation": rec,
            "cost_model_drift": drift,
        }, sys.stdout, indent=1, default=str)
        print()
        return 0
    print(render_ledger(run, reconciliation=rec))
    if rec is not None:
        from ..analysis.reconcile import format_decision_reconciliation

        print()
        print(format_decision_reconciliation(rec))
    if drift is not None:
        from ..analysis.reconcile import format_drift

        print()
        print(format_drift(drift))
    return 0


def _diff_main(path_a: str, path_b: str, as_json: bool) -> int:
    from .ledger import diff_runs, format_diff

    run_a = _read_run(path_a)
    run_b = _read_run(path_b)
    if run_a is None or run_b is None:
        return 2
    diff = diff_runs(run_a, run_b,
                     reconciliation_a=_reconcile(run_a),
                     reconciliation_b=_reconcile(run_b))
    if as_json:
        json.dump(diff, sys.stdout, indent=1, default=str)
        print()
    else:
        print(format_diff(diff))
    return 1 if diff["regressions"] else 0


def _flight_main(path: str, top: int, as_json: bool) -> int:
    try:
        trace = load_trace(path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    meta = trace.get("keystone", {}).get("flight") or {}
    incomplete = sum(
        1 for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("args", {}).get("incomplete"))
    if as_json:
        json.dump({
            "flight": meta,
            "incomplete_spans": incomplete,
            "metrics": trace.get("keystone", {}).get("metrics", {}),
            "spans": aggregate_spans(trace),
        }, sys.stdout, indent=1)
        print()
        return 0
    if meta:
        dropped = int(meta.get("dropped_spans", 0))
        print(f"flight dump: {int(meta.get('spans_held', 0))}/"
              f"{int(meta.get('capacity', 0))} span(s) in ring, "
              f"{dropped} evicted before dump, "
              f"{incomplete} in-flight at dump")
        print()
    print(summarize(trace, top=top))
    return 0


def _live_main(as_json: bool) -> int:
    from .streaming import format_health, health

    h = health()
    if as_json:
        json.dump(h, sys.stdout, indent=1, default=str)
        print()
    else:
        print(format_health(h))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.telemetry",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("trace", nargs="?",
                   help="Chrome trace JSON written by trace_run / "
                        "KEYSTONE_TRACE")
    p.add_argument("--top", type=int, default=15,
                   help="rows per section (default 15)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable digest")
    p.add_argument("--ledger", metavar="RUN",
                   help="render a run's decision ledger (JSONL file or "
                        "decision-carrying trace)")
    p.add_argument("--diff", nargs=2, metavar=("RUN_A", "RUN_B"),
                   help="run-over-run regression detection between two "
                        "runs' ledgers (exit 1 on any regression)")
    p.add_argument("--flight", metavar="DUMP",
                   help="render a flight-recorder dump: ring-window "
                        "header (capacity / evictions / in-flight "
                        "spans) followed by the trace digest")
    p.add_argument("--live", action="store_true",
                   help="render this process's live health view "
                        "(streaming latency percentiles, throughput, "
                        "conformance counters, armed watchdog)")
    p.add_argument("--emit-calibration", metavar="PATH",
                   help="with --ledger: write the run's drift-implied "
                        "cost weights in the schema of "
                        "cuda_calibration.json; "
                        "KEYSTONE_COST_CALIBRATION=<PATH> then prices "
                        "with them where the platform matches")
    args = p.parse_args(argv)
    if args.emit_calibration and not args.ledger:
        p.error("--emit-calibration requires --ledger")
    if args.diff:
        return _diff_main(args.diff[0], args.diff[1], args.as_json)
    if args.ledger:
        return _ledger_main(args.ledger, args.as_json,
                            emit_calibration=args.emit_calibration)
    if args.live:
        return _live_main(args.as_json)
    if args.flight:
        return _flight_main(args.flight, args.top, args.as_json)
    if not args.trace:
        p.error("a trace path, --ledger, --diff, --flight, or --live "
                "is required")
    try:
        trace = load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        digest = {
            "nodes": aggregate_spans(trace, "node"),
            "steps": aggregate_spans(trace, "step"),
            "chunks": aggregate_spans(trace, "chunk"),
            "metrics": trace.get("keystone", {}).get("metrics", {}),
        }
        try:
            from ..analysis.reconcile import reconcile_trace

            digest["memory_reconciliation"] = reconcile_trace(trace)
        except Exception:
            pass
        json.dump(digest, sys.stdout, indent=1)
        print()
    else:
        print(summarize(trace, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
