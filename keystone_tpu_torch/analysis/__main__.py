"""CLI: statically validate the example pipelines, audit the operator
registry, explain the plan tiers and certify serving.

Counterpart of `keystone_tpu/analysis/__main__.py:1-932`:

    python -m keystone_tpu_torch.analysis                 # all examples, full
    python -m keystone_tpu_torch.analysis MnistRandomFFT  # one example
    python -m keystone_tpu_torch.analysis --level specs --hbm-budget-gb 16
    python -m keystone_tpu_torch.analysis --audit-operators [--json]
    python -m keystone_tpu_torch.analysis --explain-sharding [--plan] [--json]
    python -m keystone_tpu_torch.analysis --explain-sharding --plan --mesh-shape 2x4
    python -m keystone_tpu_torch.analysis --explain-precision [--json]
    python -m keystone_tpu_torch.analysis --explain-roofline [--json]
    python -m keystone_tpu_torch.analysis --explain-unified [--json]
    python -m keystone_tpu_torch.analysis --certify-serving [--slo-ms 1500]
    python -m keystone_tpu_torch.analysis --list-rules

Everything runs abstractly: the stages run on meta tensors and no data
loads. The examples' weights are built on ``--device`` (default
``cuda``, which needs the card; pass ``--device cpu`` without one).

Exit code 1 where an example has an ERROR finding (any finding with
``--strict``), a build fails, ``--audit-operators`` finds any
unsuppressed KP5xx finding, ``--explain-precision`` or
``--explain-unified`` keeps a WARNING or ERROR finding under the chosen
plan (or a plan prices worse than its default, an invariant the planners
keep), ``--explain-roofline`` has an ERROR finding, or
``--certify-serving`` an unsuppressed KP9xx ERROR; 2 on a usage error.

``--explain-sharding`` (`:202-330`) propagates each example's partition
specs over the layout, prices its boundary collectives and its bytes a
card, and fails on any unsuppressed KP6xx finding; with ``--plan`` the
sharding planner chooses each stage's placement and the findings are
those under the chosen plan (on one card it has nothing to decide:
``planner: null``). ``--mesh-shape DATAxMODEL`` (`:181-205`) plans a
``(data, model)`` layout of that shape for ``--explain-sharding`` and
``--explain-unified``; the layout needs no cards (`parallel/mesh.py::
MeshLayout`), so a 2x4 deployment is priced from one card or from the
CPU. Seconds are at the card-to-card rate (`cost_model.NETWORK_WEIGHT`).
``--audit-kernels`` is not ported:
`analysis/kernels.py`'s proofs are about Mosaic's VMEM, so argparse
names the flag unknown. ``--trace-artifact`` (with ``--explain-unified``)
prices with the weights a trace's observed spans imply
(`reconcile.drift_cost_weights`).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import LEVELS, RULES, Severity
from .examples import EXAMPLES, build_example


def _finding(d) -> dict:
    return {"rule": d.rule, "severity": d.severity.name,
            "anchor": d.anchor, "message": d.message}


def _names(args):
    """The examples asked for, or None after reporting unknown ones."""
    names = args.examples or sorted(EXAMPLES)
    unknown = [n for n in names if n not in EXAMPLES]
    if unknown:
        print(f"unknown example(s): {', '.join(unknown)}; "
              f"known: {', '.join(sorted(EXAMPLES))}", file=sys.stderr)
        return None
    return names


def _budget(args):
    from ..workflow.env import execution_config

    return (int(args.hbm_budget_gb * (1 << 30))
            if args.hbm_budget_gb else execution_config().hbm_budget_bytes)


def _build_error(args, records, name, e, what) -> None:
    """A factory bug is a failure of its example, not a crash."""
    if args.json:
        records.append({"example": name, "build_error":
                        f"{type(e).__name__}: {e}"})
    else:
        print(f"✗ {name}: failed to build/{what}: "
              f"{type(e).__name__}: {e}")


def _specs(name, device):
    from . import as_source_spec
    from .propagate import spec_pass

    pipeline, source_spec = build_example(name, device=device)
    graph = pipeline.graph
    specs, _ = spec_pass(graph, {pipeline.source: as_source_spec(source_spec)})
    return graph, specs


def _audit_main(args) -> int:
    """The registry-wide operator contract audit (KP5xx, `:84-113`)."""
    from .contracts import audit_registry

    findings, stats = audit_registry()
    if args.ignore:
        findings = [(c, d) for c, d in findings if d.rule not in args.ignore]
    if args.json:
        print(json.dumps({
            "audited_classes": stats["classes"],
            "probed_classes": stats["probed"],
            "findings": [
                {
                    "class": cls.__qualname__,
                    "module": cls.__module__,
                    "rule": d.rule,
                    "severity": d.severity.name,
                    "message": d.message,
                }
                for cls, d in findings
            ],
        }, indent=2))
        return 1 if findings else 0
    for cls, d in findings:
        print(f"✗ {cls.__module__}.{cls.__qualname__}: "
              f"[{d.severity.name}] {d.rule} {d.message}")
    mark = "✗" if findings else "✓"
    print(f"{mark} operator contract audit: {stats['classes']} class(es) "
          f"swept ({stats['probed']} probed), {len(findings)} finding(s)")
    return 1 if findings else 0


def _parse_mesh_shape(raw):
    """``--mesh-shape 2x4`` → the layout ``{"data": 2, "model": 4}``
    (`:181-205`); None where the flag is absent (the current mesh: one
    card without a process group). Raises ValueError on a malformed
    shape."""
    if not raw:
        return None
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, MeshLayout

    try:
        parts = [int(p) for p in raw.lower().split("x")]
    except ValueError:
        parts = []
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise ValueError(f"--mesh-shape must be DATAxMODEL (e.g. 2x4), "
                         f"got {raw!r}")
    return MeshLayout({DATA_AXIS: parts[0], MODEL_AXIS: parts[1]})


def _explain_sharding_main(args) -> int:
    """Per-example sharding explanation (KP6xx gate, `:208-330`):
    propagate the partition specs, scale memory to one card, price the
    boundary collectives, and fail on any unsuppressed KP6xx finding.
    With ``--plan`` the sharding planner chooses a placement per example
    and the findings are computed under the chosen plan."""
    from ..parallel.mesh import layout_of
    from .memory import memory_pass
    from .planner import format_plan, plan_sharding
    from .sharding import (
        explain_rows,
        format_explain,
        per_device_pass,
        sharding_pass,
    )

    names = _names(args)
    if names is None:
        return 2
    try:
        mesh = layout_of(_parse_mesh_shape(args.mesh_shape))
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    budget = _budget(args)
    failed = False
    records = []
    for name in names:
        try:
            graph, specs = _specs(name, args.device)
            splan = None
            plan_choices = None
            if args.plan:
                splan = plan_sharding(graph, specs, mesh=mesh,
                                      hbm_budget_bytes=budget)
                plan_choices = splan.choices if splan else None
            shardings, diags, boundary = sharding_pass(
                graph, specs, mesh=mesh, plan=plan_choices)
            est, _ = memory_pass(graph, specs)
            per_dev, pd_diags = per_device_pass(
                graph, specs, shardings, est, mesh=mesh,
                hbm_budget_bytes=budget)
            diags = [d for d in diags + pd_diags
                     if d.rule not in set(args.ignore)]
            rows = explain_rows(graph, specs, shardings, boundary, per_dev)
        except Exception as e:
            _build_error(args, records, name, e, "explain")
            failed = True
            continue
        failed |= bool(diags)
        if args.json:
            rec = {
                "example": name,
                "devices": mesh.size,
                "per_device_peak_bytes": est.per_device_peak_bytes,
                "stages": rows,
                "findings": [_finding(d) for d in diags],
            }
            if splan is not None:
                rec["planner"] = {
                    "planned_cost_bytes": int(splan.planned_cost_bytes),
                    "default_cost_bytes": int(splan.default_cost_bytes),
                    "savings_bytes": splan.savings_bytes,
                    "improved": splan.improved,
                    "changed_stages": len(splan.changed_vertices()),
                    "stages": splan.rows(graph),
                }
            elif args.plan:
                rec["planner"] = None  # nothing to decide (one card)
            records.append(rec)
        else:
            mark = "✗" if diags else "✓"
            print(f"{mark} {name} (mesh: {mesh.size} device(s), "
                  f"per-device peak ≈ {est.per_device_peak_bytes >> 10} "
                  "KiB)")
            if splan is not None:
                print(f"  planner: boundary bytes "
                      f"{int(splan.default_cost_bytes):,} (default) → "
                      f"{int(splan.planned_cost_bytes):,} (chosen), "
                      f"{splan.savings_bytes:,} saved, "
                      f"{len(splan.changed_vertices())} stage(s) changed")
                print("  " + format_plan(splan.rows(graph))
                      .replace("\n", "\n  "))
            else:
                if args.plan:
                    print("  planner: nothing to decide on one card")
                print("  " + format_explain(rows).replace("\n", "\n  "))
            for d in diags:
                print(f"    {d}")
    if args.json:
        print(json.dumps({"devices": mesh.size, "examples": records},
                         indent=2))
    return 1 if failed else 0


def _explain_precision_main(args) -> int:
    """The precision planner per example (KP7xx gate, `:333-440`): the
    chosen storage dtypes, the bytes saved, the findings under the
    chosen policy and the memory model re-priced with its dtypes."""
    from .precision import (
        format_plan,
        plan_precision,
        precision_pass,
        reprice_memory,
    )

    names = _names(args)
    if names is None:
        return 2
    failed = False
    records = []
    for name in names:
        try:
            graph, specs = _specs(name, args.device)
            pplan = plan_precision(graph, specs)
            diags = []
            repriced = None
            if pplan is not None:
                diags = precision_pass(graph, specs, pplan)
                est0, est1, kp703 = reprice_memory(graph, specs, pplan)
                diags.extend(kp703)
                repriced = {
                    "peak_bytes_default": int(est0.peak_bytes),
                    "peak_bytes_planned": int(est1.peak_bytes),
                }
            diags = [d for d in diags if d.rule not in set(args.ignore)]
            gate = [d for d in diags if d.severity >= Severity.WARNING]
        except Exception as e:
            _build_error(args, records, name, e, "explain")
            failed = True
            continue
        over = (pplan is not None
                and pplan.planned_cost_bytes > pplan.default_cost_bytes)
        failed |= bool(gate) or over
        if args.json:
            rec = {"example": name,
                   "findings": [_finding(d) for d in diags]}
            if pplan is not None:
                rec["planner"] = {
                    "planned_cost_bytes": int(pplan.planned_cost_bytes),
                    "default_cost_bytes": int(pplan.default_cost_bytes),
                    "savings_bytes": pplan.savings_bytes,
                    "improved": pplan.improved,
                    "changed_stages": len(pplan.changed_vertices()),
                    "stages": pplan.rows(graph, specs),
                }
                if repriced:
                    rec["planner"]["memory"] = repriced
            else:
                rec["planner"] = None  # nothing to decide
            records.append(rec)
        else:
            mark = "✗" if (gate or over) else "✓"
            if pplan is None:
                print(f"{mark} {name}: no tolerant float boundary — "
                      "policy stays all-f32")
                continue
            print(f"{mark} {name}: boundary bytes "
                  f"{int(pplan.default_cost_bytes):,} (f32) → "
                  f"{int(pplan.planned_cost_bytes):,} (chosen), "
                  f"{pplan.savings_bytes:,} saved, "
                  f"{len(pplan.changed_vertices())} stage(s) reduced")
            print("  " + format_plan(pplan.rows(graph, specs))
                  .replace("\n", "\n  "))
            for d in diags:
                if d.severity >= Severity.WARNING or args.strict:
                    print(f"    {d}")
    if args.json:
        print(json.dumps({"examples": records}, indent=2))
    return 1 if failed else 0


def _explain_roofline_main(args) -> int:
    """The roofline per example (KP8xx, `:443-519`): every priced
    stage's FLOPs, bytes, intensity, bound and predicted seconds, and the
    KP801 kernel candidates. Advisory: only ERROR findings or a failed
    build fail it."""
    from .roofline import format_roofline, roofline_pass

    names = _names(args)
    if names is None:
        return 2
    failed = False
    records = []
    machine = None
    for name in names:
        try:
            graph, specs = _specs(name, args.device)
            est, diags = roofline_pass(graph, specs)
            machine = est.machine
            diags = [d for d in diags if d.rule not in set(args.ignore)]
            gate = [d for d in diags if d.severity >= Severity.ERROR]
            rows = est.rows(graph)
        except Exception as e:
            _build_error(args, records, name, e, "explain")
            failed = True
            continue
        failed |= bool(gate)
        if args.json:
            records.append({
                "example": name,
                "plan_predicted_seconds": est.plan_seconds,
                "unpriced_stages": est.unknown_stages,
                "stages": rows,
                "candidates": [
                    {**c, "vertices": [v.id for v in c["vertices"]]}
                    for c in est.candidates
                ],
                "findings": [_finding(d) for d in diags],
            })
        else:
            mark = "✗" if gate else "✓"
            print(f"{mark} {name}: {len(rows)} priced stage(s), "
                  f"≈{est.plan_seconds:.3e}s predicted, "
                  f"{len(est.candidates)} kernel candidate(s)"
                  + (f", {est.unknown_stages} unpriced"
                     if est.unknown_stages else ""))
            if rows:
                print("  " + format_roofline(rows).replace("\n", "\n  "))
            for d in diags:
                if d.severity >= Severity.WARNING or args.strict:
                    print(f"    {d}")
    if args.json:
        print(json.dumps({
            "machine": {
                "peak_flops": machine.peak_flops,
                "peak_bw": machine.peak_bw,
                "balance": machine.balance,
            } if machine is not None else None,
            "examples": records,
        }, indent=2, default=str))
    return 1 if failed else 0


def _explain_unified_main(args) -> int:
    """The unified plan per example (`:522-703`): joint against
    sequential seconds, the chosen axes, and the findings under the
    chosen plan (the card's budget at the chosen chunk, KP7xx against
    the joint dtypes, KP8xx errors at the chosen chunk)."""
    from ..parallel.mesh import layout_of
    from .memory import memory_pass
    from .plan_ir import format_plan, plan_unified
    from .precision import precision_pass
    from .roofline import roofline_pass
    from .sharding import per_device_pass, sharding_pass

    names = _names(args)
    if names is None:
        return 2
    try:
        mesh = layout_of(_parse_mesh_shape(args.mesh_shape))
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    weights = None
    if args.trace_artifact:
        from .reconcile import drift_cost_weights

        with open(args.trace_artifact) as f:
            weights = drift_cost_weights(json.load(f))
    budget = _budget(args)
    failed = False
    records = []
    for name in names:
        try:
            graph, specs = _specs(name, args.device)
            uplan = plan_unified(graph, specs, mesh=mesh,
                                 hbm_budget_bytes=budget, weights=weights)
            diags = []
            if uplan is not None:
                plan_choices = (uplan.sharding.choices
                                if uplan.sharding else None)
                shardings, s_diags, _ = sharding_pass(
                    graph, specs, mesh=mesh, plan=plan_choices)
                # the budget holds at the chunk the plan enforces
                est, _ = memory_pass(graph, specs,
                                     chunk_rows=uplan.chunk_size)
                _, pd_diags = per_device_pass(
                    graph, specs, shardings, est, mesh=mesh,
                    hbm_budget_bytes=budget)
                diags.extend(s_diags)
                diags.extend(pd_diags)
                if uplan.boundary_precision is not None:
                    diags.extend(precision_pass(
                        graph, specs, uplan.boundary_precision))
                _, r_diags = roofline_pass(
                    graph, specs, chunk_rows=uplan.chunk_size)
                diags.extend(d for d in r_diags
                             if d.severity >= Severity.ERROR)
            diags = [d for d in diags if d.rule not in set(args.ignore)]
            gate = [d for d in diags if d.severity >= Severity.WARNING]
        except Exception as e:
            _build_error(args, records, name, e, "explain")
            failed = True
            continue
        over = (uplan is not None
                and uplan.joint_seconds > uplan.sequential_seconds)
        failed |= bool(gate) or over
        if args.json:
            rec = {"example": name,
                   "findings": [_finding(d) for d in diags]}
            if uplan is not None:
                rec["planner"] = {
                    "joint_seconds": uplan.joint_seconds,
                    "sequential_seconds": uplan.sequential_seconds,
                    "savings_seconds": uplan.savings_seconds,
                    "improved": uplan.improved,
                    "chunk_size": uplan.chunk_size,
                    "sequential_chunk_size": uplan.default_chunk_size,
                    "cache_points": [v.id for v in uplan.cache_vertices],
                    "changed_kinds": uplan.changed_kinds(),
                    "unpriced_stages": uplan.unpriced_stages,
                    "stages": uplan.rows(graph),
                    "scored_candidates": uplan.scored_candidates,
                }
            else:
                rec["planner"] = None  # nothing to decide
            records.append(rec)
        else:
            mark = "✗" if (gate or over) else "✓"
            if uplan is None:
                print(f"{mark} {name}: nothing to decide (no priced "
                      "stage / no axis with more than one entry)")
                continue
            print(f"{mark} {name}:")
            print("  " + format_plan(uplan, graph).replace("\n", "\n  "))
            if uplan.unpriced_stages:
                print(f"  ({uplan.unpriced_stages} stage(s) "
                      "unpriced — excluded from both sides)")
            for d in diags:
                if d.severity >= Severity.WARNING or args.strict:
                    print(f"    {d}")
    if args.json:
        print(json.dumps({"devices": mesh.size, "examples": records},
                         indent=2, default=str))
    return 1 if failed else 0


def _certify_serving_main(args) -> int:
    """The KP9xx serving certificate per example (`:706-790`), against
    the declared envelope; examples that cannot certify yet carry the
    named suppressions of `serving.SERVING_SUPPRESSIONS`."""
    from .serving import (
        SERVING_SUPPRESSIONS,
        ServingEnvelope,
        certify_example,
        envelope_from_env,
        format_certificate,
    )

    names = _names(args)
    if names is None:
        return 2
    base = envelope_from_env(require_slo=False)
    envelope = ServingEnvelope(
        max_batch=args.max_batch or base.max_batch,
        slo_seconds=(args.slo_ms / 1e3) if args.slo_ms else base.slo_seconds,
        tenants=args.tenants or base.tenants)
    budget = _budget(args)
    failed = False
    records = []
    for name in names:
        try:
            cert, diags = certify_example(
                name, envelope, hbm_budget_bytes=budget, record=True,
                device=args.device)
        except Exception as e:
            _build_error(args, records, name, e, "certify")
            failed = True
            continue
        suppressions = dict(SERVING_SUPPRESSIONS.get(name, {}))
        ignored = set(args.ignore)
        gate = [d for d in diags if d.severity >= Severity.ERROR
                and d.rule not in suppressions and d.rule not in ignored]
        suppressed = sorted({d.rule for d in diags
                             if d.severity >= Severity.ERROR
                             and d.rule in suppressions})
        failed |= bool(gate)
        if args.json:
            records.append({
                "example": name,
                "certified": cert.certified,
                "unsuppressed_errors": len(gate),
                "suppressions": {r: suppressions[r] for r in suppressed},
                "certificate": cert.as_record(),
                "findings": [_finding(d) for d in diags],
            })
        else:
            mark = "✗" if gate else "✓"
            verdict = ("certified" if cert.certified else
                       ("uncertified (suppressed: " + ", ".join(suppressed)
                        + ")" if suppressed and not gate else "UNCERTIFIED"))
            print(f"{mark} {name}: {verdict}")
            print("  " + format_certificate(cert).replace("\n", "\n  "))
            for rule in suppressed:
                print(f"    suppressed {rule}: {suppressions[rule]}")
            for d in diags:
                if d.severity >= Severity.WARNING or args.strict:
                    print(f"    {d}")
    if args.json:
        print(json.dumps({
            "envelope": {
                "min_batch": envelope.min_batch,
                "max_batch": envelope.max_batch,
                "slo_seconds": envelope.slo_seconds,
                "tenants": envelope.tenants,
            },
            "examples": records,
        }, indent=2, default=str))
    return 1 if failed else 0


def _validate_main(args) -> int:
    """Every named example validated to ``--level`` (`:869-927`)."""
    names = _names(args)
    if names is None:
        return 2
    budget = (int(args.hbm_budget_gb * (1 << 30))
              if args.hbm_budget_gb else None)
    failed = False
    records = []
    for name in names:
        try:
            pipeline, source_spec = build_example(name, device=args.device)
            report = pipeline.validate(
                source_spec, level=args.level, ignore=args.ignore,
                hbm_budget_bytes=budget, raise_on_error=False)
        except Exception as e:
            _build_error(args, records, name, e, "validate")
            failed = True
            continue
        bad = bool(report.errors) or (args.strict and report.warnings)
        if args.json:
            records.append({
                "example": name,
                "errors": len(report.errors),
                "warnings": len(report.warnings),
                "diagnostics": [_finding(d) for d in report.diagnostics],
            })
        else:
            mark = "✗" if bad else "✓"
            print(f"{mark} {name}: {len(report.errors)} error(s), "
                  f"{len(report.warnings)} warning(s)"
                  + (f", peak ≈ {report.memory.peak_bytes >> 20} MiB"
                     if report.memory and report.memory.peak_bytes else ""))
            for d in report.diagnostics:
                if d.severity >= Severity.WARNING or args.strict:
                    print(f"    {d}")
        failed |= bad
    if args.json:
        print(json.dumps({"examples": records}, indent=2))
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("examples", nargs="*", metavar="EXAMPLE",
                   help="example names (default: all registered)")
    p.add_argument("--device", default="cuda",
                   help="where the examples' weights are built (default "
                        "cuda; cpu without a card)")
    p.add_argument("--level", choices=LEVELS, default="full")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="device memory budget (GiB)")
    p.add_argument("--ignore", action="append", default=[], metavar="RULE",
                   help="suppress a rule id (repeatable)")
    p.add_argument("--strict", action="store_true",
                   help="fail on warnings too")
    p.add_argument("--audit-operators", action="store_true",
                   help="sweep every operator class of the port for KP5xx "
                        "contract violations (none tolerated)")
    p.add_argument("--explain-sharding", action="store_true",
                   help="render each example's per-stage partition spec, "
                        "bytes a card and priced boundary collectives; "
                        "fail on any unsuppressed KP6xx finding")
    p.add_argument("--mesh-shape", default=None, metavar="DATAxMODEL",
                   help="with --explain-sharding or --explain-unified: "
                        "plan a (data, model) layout of this shape, e.g. "
                        "2x4 (no cards needed)")
    p.add_argument("--explain-precision", action="store_true",
                   help="run the precision planner per example and render "
                        "the per-stage dtypes and bytes saved; fail on any "
                        "unsuppressed WARNING/ERROR KP7xx finding")
    p.add_argument("--explain-roofline", action="store_true",
                   help="render each example's per-stage flops, bytes, "
                        "intensity, bound and predicted seconds with the "
                        "KP801 kernel candidates; fail only on ERROR "
                        "findings")
    p.add_argument("--explain-unified", action="store_true",
                   help="run the unified plan optimizer per example and "
                        "render joint against sequential scores with the "
                        "findings under the chosen plan")
    p.add_argument("--trace-artifact", default=None, metavar="TRACE",
                   help="with --explain-unified: price with the weights "
                        "this trace's observed spans imply")
    p.add_argument("--certify-serving", action="store_true",
                   help="run the KP9xx serving certifier per example; "
                        "fail on any unsuppressed KP9xx ERROR")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="serving SLO in milliseconds for --certify-serving "
                        "(default: KEYSTONE_SLO_MS or 1000)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="largest coalesced request batch the envelope "
                        "certifies (default: KEYSTONE_SERVING_MAX_BATCH "
                        "or 64)")
    p.add_argument("--tenants", type=int, default=None,
                   help="concurrent warmed pipelines sharing the card "
                        "(KP905; default 1)")
    p.add_argument("--plan", action="store_true",
                   help="with --explain-sharding: run the sharding planner "
                        "and report findings under the chosen placement")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if args.audit_operators:
        return _audit_main(args)
    # the examples' weights go to the card unless --device cpu; without
    # a card the default raises here
    from ..device import resolve_device

    args.device = resolve_device(args.device)
    if args.explain_sharding:
        return _explain_sharding_main(args)
    if args.explain_precision:
        return _explain_precision_main(args)
    if args.explain_roofline:
        return _explain_roofline_main(args)
    if args.explain_unified:
        return _explain_unified_main(args)
    if args.certify_serving:
        return _certify_serving_main(args)
    return _validate_main(args)


if __name__ == "__main__":
    sys.exit(main())
