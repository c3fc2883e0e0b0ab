"""Static against observed: memory bytes, roofline seconds, serving
bounds and the optimizer's decisions, joined over a trace.

Counterpart of `keystone_tpu/analysis/reconcile.py:1-812`, function for
function (`node_key` `:42` to `format_reconciliation` `:778`), with the
same keys and the same text, so that for the same trace and run dicts
each function returns what JAX's returns. It is dict processing over the
trace JSON both packages write (`telemetry/export.py`):

  - `reconcile_trace`: the memory pass's per-node bytes
    (``keystone.static_memory``, embedded by `GraphExecutor` under a
    tracer) against each ``cat="node"`` span's ``out_bytes``;
  - `reconcile_decisions`: the decision ledger (`telemetry/ledger.py`)
    against what the run did: program counts, fused spans' bytes, the
    ``chain_kernel`` spans (`nodes/util/fusion.py`), spill windows and
    the watchdog's conformance records;
  - `reconcile_roofline`: ``keystone.roofline``'s predicted seconds per
    stage against the node spans' ``seconds``, and each ``chain_kernel``
    span's ``predicted_seconds`` against its duration;
  - `reconcile_serving`: the KP9xx certificate's per-rung bounds against
    measured per-rung percentiles;
  - `cost_model_drift` / `drift_cost_weights`: the cost weights the
    observed spans imply, as the `nodes/learning/calibrate.py::CostWeights`
    that `telemetry/__main__.py --emit-calibration` writes in the schema
    of `cuda_calibration.json`.

On the card a node span's ``seconds`` are the host's time for its force:
a tracer alone adds no synchronization (`telemetry/instrument.py`), so a
stage whose work is only queued reads short. The ``chain_kernel`` span
is synchronized while a tracer is active, so a kernel row reads the
card's time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def node_key(vertex, label: str) -> str:
    return f"{vertex}:{label}"


def observed_node_bytes(trace: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """key → {label, vertex, bytes, forces} from ``cat="node"`` spans."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "node":
            continue
        args = e.get("args", {})
        vertex = args.get("vertex")
        if vertex is None:
            continue
        label = e.get("name", "")
        if label.startswith("force "):
            label = label[len("force "):]
        key = node_key(vertex, label)
        rec = out.setdefault(key, {
            "label": label, "vertex": vertex, "bytes": 0.0, "forces": 0,
        })
        rec["forces"] += 1
        rec["bytes"] = max(rec["bytes"], float(args.get("out_bytes", 0.0) or 0.0))
    return out


def reconcile_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Join the trace's static estimates against its observed bytes.

    Returns ``{"rows": [...], "static_peak_bytes", "observed_peak_bytes",
    "peak_rel_error", "static_per_device_peak_bytes"}`` where each row
    carries ``label``, ``vertex``, ``static_bytes``, ``observed_bytes``
    and ``rel_error`` (signed, relative to the observation: +1.0 means
    the model predicted double), plus — when the sharding tier ran — the
    propagated ``spec`` and ``static_per_device_bytes`` (one shard's
    predicted bytes; on a mesh this is what each chip's allocator sees,
    the number the KP600 budget lints against). Nodes with only one side
    known are reported with ``rel_error=None`` so coverage gaps stay
    visible instead of silently dropping."""
    ks = trace.get("keystone", {})
    static = (ks.get("static_memory") or {}).get("per_node", {})
    observed = observed_node_bytes(trace)
    rows: List[Dict[str, Any]] = []
    for key in sorted(set(static) | set(observed)):
        s = static.get(key)
        o = observed.get(key)
        static_b: Optional[float] = float(s["bytes"]) if s else None
        obs_b: Optional[float] = float(o["bytes"]) if o else None
        rel: Optional[float] = None
        if static_b is not None and obs_b:
            rel = (static_b - obs_b) / obs_b
        rows.append({
            "key": key,
            "label": (s or o)["label"],
            "vertex": (s or o).get("vertex", key.split(":", 1)[0]),
            "static_bytes": static_b,
            "observed_bytes": obs_b,
            "rel_error": rel,
            "spec": (s or {}).get("spec"),
            # the propagated boundary dtype — uint8/int32 loader stages
            # and precision-planner bf16 decisions are visible here, so
            # a dtype-blind estimate can no longer hide behind a byte
            # count that happens to match
            "dtype": (s or {}).get("dtype"),
            "static_per_device_bytes": (s or {}).get("per_device_bytes"),
        })
    # nodes with both sides first, largest observation first — the head
    # of the table is what calibration actually reads
    rows.sort(key=lambda r: (r["rel_error"] is None,
                             -(r["observed_bytes"] or 0.0)))
    static_peak = (ks.get("static_memory") or {}).get("peak_bytes")
    # per-run peak tracked on the tracer; the registry gauge is
    # cumulative across every run in the process, so it is only a
    # fallback for traces written before the per-run field existed
    observed_peak = ks.get("observed_live_peak_bytes") or (
        ks.get("metrics", {}).get("gauges", {})
        .get("executor.live_bytes", {}).get("max")
    )
    peak_rel = None
    if static_peak and observed_peak:
        peak_rel = (static_peak - observed_peak) / observed_peak
    return {
        "rows": rows,
        "static_peak_bytes": static_peak,
        "observed_peak_bytes": observed_peak,
        "peak_rel_error": peak_rel,
        "static_per_device_peak_bytes": (
            (ks.get("static_memory") or {}).get("per_device_peak_bytes")),
    }


# ------------------------------------------------- decision reconciliation


def _node_spans_by_label(trace: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """label → {forces, out_bytes(max)} over ``cat="node"`` spans (the
    fit/apply vertex-id split collapsed — decisions key on labels)."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "node":
            continue
        name = e.get("name", "")
        if name.startswith("force "):
            name = name[len("force "):]
        rec = out.setdefault(name, {"forces": 0, "out_bytes": 0.0})
        rec["forces"] += 1
        rec["out_bytes"] = max(
            rec["out_bytes"],
            float(e.get("args", {}).get("out_bytes", 0.0) or 0.0))
    return out


def _counter_value(trace: Dict[str, Any], name: str) -> Optional[float]:
    c = (trace.get("keystone", {}).get("metrics", {})
         .get("counters", {}).get(name))
    return float(c["value"]) if c and "value" in c else None


def reconcile_decisions(run: Dict[str, Any]) -> Dict[str, Any]:
    """Join a run's decision ledger (`telemetry.ledger.read_ledger`)
    against its trace: what was decided and predicted vs what the run
    observably did.

    Returns ``{"rows", "run_predicted", "run_observed", "residuals"}``:

      - ``rows`` — one row per decision: ``{seq, kind, labels,
        predicted, observed, residuals}``. Fusion/megafusion rows
        observe the fused program's span forces and output bytes
        (megafused programs via their ``megafused_program`` spans);
        placement rows observe the changed stages' boundary bytes and
        carry the predicted-minus-observed byte residual; precision
        rows observe their program's span bytes.
      - ``run_predicted`` / ``run_observed`` / ``residuals`` — the
        run-level predicted-vs-observed join: ``programs_executed``
        (sum of the megafusion decisions' chosen program counts — exact
        on a trace covering one apply run of a fully megafused plan,
        which is what the exactness tests pin), ``programs_compiled``
        (cold-compile upper bound vs the compile counter),
        ``megafused_programs``, ``casts_baked``, and
        ``boundary_bytes_saved`` (predicted only — the savings the
        placement/precision decisions priced).

    Registry counters in a trace are process-cumulative: reset the
    registry (or use a fresh process) when a run-exact join is needed —
    `dispatch_bench.measure_example` slices its own window."""
    from ..telemetry.ledger import decision_key

    trace = run.get("trace") or {}
    decisions = run.get("decisions") or []
    by_label = _node_spans_by_label(trace)
    mega_spans = [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("name") == "megafused_program"
    ]
    kernel_spans = [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("name") == "chain_kernel"
    ]
    request_spans = [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") == "request"
    ]

    unique: Dict = {}
    for d in decisions:
        unique.setdefault(decision_key(d), d)

    rows: List[Dict[str, Any]] = []
    for d in decisions:
        pred = d.get("predicted") or {}
        observed: Dict[str, Any] = {}
        residuals: Dict[str, Any] = {}
        labels = d.get("labels") or []
        kind = d.get("kind")
        if kind == "megafusion":
            n = len(mega_spans)
            n_mega_decisions = sum(
                1 for k in unique if k[0] == "megafusion")
            observed["programs_executed"] = n
            if n and n_mega_decisions == 1 \
                    and "programs_per_apply" in pred:
                # exact only when the trace covers one apply run of the
                # one megafused program — the pinned-test shape; a
                # longer trace shows the positive residual honestly
                residuals["programs_per_apply"] = (
                    pred["programs_per_apply"] - n)
            trips = sum(
                float(e.get("args", {}).get("scan_trips", 0) or 0)
                for e in mega_spans)
            if trips:
                observed["scan_trips"] = int(trips)
        elif kind == "fusion":
            # the fused program's span label embeds its member labels
            hits = [v for lbl, v in by_label.items()
                    if labels and labels[0] in lbl]
            if hits:
                observed["forces"] = sum(h["forces"] for h in hits)
                observed["out_bytes"] = max(h["out_bytes"] for h in hits)
        elif kind == "placement":
            total = 0.0
            found = False
            for lbl in labels:
                for span_lbl, v in by_label.items():
                    if lbl and lbl in span_lbl:
                        total += v["out_bytes"]
                        found = True
                        break
            if found:
                observed["boundary_bytes"] = total
                if "boundary_bytes" in pred:
                    residuals["boundary_bytes"] = (
                        float(pred["boundary_bytes"]) - total)
        elif kind == "precision":
            hits = [v for lbl, v in by_label.items()
                    if labels and labels[0] in lbl]
            if hits:
                observed["out_bytes"] = max(h["out_bytes"] for h in hits)
        elif kind == "kernel":
            # the chain-kernel decision observes its own span: one
            # `chain_kernel` interval per kernel-bearing dispatch, with
            # the planner's predicted seconds riding as a span arg
            hits = []
            for e in kernel_spans:
                sl = str(e.get("args", {}).get("label", ""))
                if any(lbl and (lbl in sl or sl in lbl)
                       for lbl in labels):
                    hits.append(e)
            if hits:
                observed["kernel_dispatches"] = len(hits)
                obs_sec = max(float(e.get("dur", 0.0) or 0.0) / 1e6
                              for e in hits)
                if obs_sec:
                    observed["kernel_seconds"] = obs_sec
                    pred_k = sum(
                        float(k.get("kernel_seconds") or 0.0)
                        for k in ((d.get("chosen") or {})
                                  .get("kernels") or []))
                    if pred_k:
                        residuals["kernel_seconds"] = pred_k - obs_sec
        elif kind == "spill":
            # the spill decision observes the windowed reload machinery
            # it priced: `spill_window` spans (one per host→device
            # window trip), the spill byte counters, and the measured
            # reload-stall histogram — residual is the planner's
            # predicted reload seconds minus the observed stall total
            spill_spans = [
                e for e in trace.get("traceEvents", [])
                if e.get("ph") == "X" and e.get("name") == "spill_window"
            ]
            if spill_spans:
                observed["window_trips"] = len(spill_spans)
            for metric, cname in (("bytes_out", "spill.bytes_out"),
                                  ("bytes_in", "spill.bytes_in")):
                v = _counter_value(trace, cname)
                if v is not None:
                    observed[metric] = v
            hist = (trace.get("keystone", {}).get("metrics", {})
                    .get("histograms", {}).get("spill.reload_stall_s"))
            if hist and hist.get("count"):
                observed["reload_stall_s"] = float(hist["total"])
                if "reload_seconds" in pred and pred["reload_seconds"]:
                    residuals["reload_seconds"] = (
                        float(pred["reload_seconds"])
                        - float(hist["total"]))
        elif kind == "conformance":
            # the watchdog's breach record joins against the live
            # request spans at the SAME padded shape: observed is the
            # worst request the trace holds for that shape, residual is
            # certified bound minus observed (negative == breach held
            # up in the artifact, not only in the counter)
            chosen = d.get("chosen") or {}
            shape = chosen.get("chunk_shape")
            hits = [
                e for e in request_spans
                if shape is None
                or e.get("args", {}).get("chunk_shape") == shape
            ]
            if hits:
                observed["request_spans"] = len(hits)
                obs_sec = max(
                    float(e.get("dur", 0.0) or 0.0) / 1e6 for e in hits)
                observed["observed_seconds"] = obs_sec
                if "bound_seconds" in pred and pred["bound_seconds"]:
                    residuals["bound_seconds"] = (
                        float(pred["bound_seconds"]) - obs_sec)
            elif "observed_seconds" in chosen:
                # dump window may have rotated past the request span:
                # the record itself still carries the observation
                observed["observed_seconds"] = chosen["observed_seconds"]
                if "bound_seconds" in pred and pred["bound_seconds"]:
                    residuals["bound_seconds"] = (
                        float(pred["bound_seconds"])
                        - float(chosen["observed_seconds"]))
        rows.append({
            "seq": d.get("seq"),
            "kind": kind,
            "labels": labels,
            "predicted": pred,
            "observed": observed,
            "residuals": residuals,
        })

    run_predicted: Dict[str, Any] = {}
    mega_unique = [d for k, d in unique.items() if k[0] == "megafusion"]
    if mega_unique:
        run_predicted["programs_executed"] = sum(
            int((d.get("chosen") or {}).get("programs", 1))
            for d in mega_unique)
        run_predicted["megafused_programs"] = len(mega_unique)
    compile_max = sum(
        int((d.get("predicted") or {}).get("cold_compiles_max", 0))
        for k, d in unique.items() if k[0] in ("fusion", "megafusion"))
    if compile_max:
        run_predicted["programs_compiled_max"] = compile_max
    casts = sum(
        int((d.get("predicted") or {}).get("casts_baked", 0))
        for k, d in unique.items() if k[0] == "precision")
    if any(k[0] == "precision" for k in unique):
        run_predicted["casts_baked"] = casts
    saved = sum(
        int((d.get("predicted") or {}).get("boundary_bytes_saved", 0))
        + int((d.get("predicted") or {}).get("policy_bytes_saved", 0))
        for d in unique.values())
    if saved:
        run_predicted["boundary_bytes_saved"] = saved

    run_observed: Dict[str, Any] = {}
    for metric, counter_name in (
            ("programs_executed", "dispatch.programs_executed"),
            ("programs_compiled", "dispatch.programs_compiled"),
            ("megafused_programs", "megafusion.programs"),
            ("casts_baked", "precision.casts_baked")):
        v = _counter_value(trace, counter_name)
        if v is not None:
            run_observed[metric] = v

    residuals: Dict[str, Any] = {}
    for metric in set(run_predicted) & set(run_observed):
        residuals[metric] = run_predicted[metric] - run_observed[metric]
    if "programs_compiled_max" in run_predicted \
            and "programs_compiled" in run_observed:
        residuals["programs_compiled"] = (
            run_predicted["programs_compiled_max"]
            - run_observed["programs_compiled"])

    return {
        "rows": rows,
        "run_predicted": run_predicted,
        "run_observed": run_observed,
        "residuals": residuals,
    }


def format_decision_reconciliation(rec: Dict[str, Any]) -> str:
    lines = ["== decisions: predicted vs observed (run level) =="]
    keys = sorted(set(rec["run_predicted"]) | set(rec["run_observed"]))
    if not keys:
        lines.append("(no run-level quantities on both sides)")
    for k in keys:
        p = rec["run_predicted"].get(k)
        o = rec["run_observed"].get(k)
        r = rec["residuals"].get(k)
        lines.append(
            f"{k:<24} predicted={'—' if p is None else p:>12} "
            f"observed={'—' if o is None else o:>12} "
            f"residual={'—' if r is None else r}")
    return "\n".join(lines)


# ------------------------------------------------- roofline reconciliation


def observed_node_seconds(trace: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """key → {label, vertex, seconds(max over forces), forces} from
    ``cat="node"`` spans — the observed side of the roofline's time
    model. The roofline predicts ONE dataset pass per stage, and a
    fit+apply run forces the same vertex:label more than once, so
    seconds aggregate with **max** (the `observed_node_bytes`
    precedent) — summing would inflate the residual and the implied
    ``cpu_weight`` by the force count."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "node":
            continue
        args = e.get("args", {})
        vertex = args.get("vertex")
        if vertex is None:
            continue
        label = e.get("name", "")
        if label.startswith("force "):
            label = label[len("force "):]
        key = node_key(vertex, label)
        rec = out.setdefault(key, {
            "label": label, "vertex": vertex, "seconds": 0.0, "forces": 0,
        })
        rec["forces"] += 1
        rec["seconds"] = max(rec["seconds"],
                             float(args.get("seconds", 0.0) or 0.0))
    return out


def reconcile_roofline(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Join the trace's embedded roofline predictions
    (``keystone.roofline`` — per-stage flops / bytes / predicted
    seconds, the KP803 metadata the executor records) against the
    observed per-node span seconds.

    Returns ``{"rows", "kernels", "predicted_seconds",
    "observed_seconds", "flops_residual_seconds", "stages_joined",
    "machine"}`` — ``kernels`` joins every ``chain_kernel`` span's
    planner-predicted seconds against its observed wall duration (the
    kernel-axis side of the drift report). Each stage
    row carries ``predicted_seconds``, ``observed_seconds``,
    ``residual`` (predicted − observed; positive means the model
    promised more time than the run took) and the static ``flops`` /
    ``bound``. Rows with only one side known are kept with
    ``residual=None`` so coverage gaps stay visible; a trace with no
    roofline metadata (or no spans) degrades to empty rows instead of
    raising — the --ledger drift report must render on partial
    artifacts."""
    ks = trace.get("keystone", {})
    roof = ks.get("roofline") or {}
    static = roof.get("per_node", {}) or {}
    observed = observed_node_seconds(trace)
    rows: List[Dict[str, Any]] = []
    pred_total = 0.0
    obs_total = 0.0
    joined = 0
    for key in sorted(set(static) | set(observed)):
        s = static.get(key)
        o = observed.get(key)
        pred: Optional[float] = (
            float(s["predicted_seconds"]) if s else None)
        obs: Optional[float] = (
            float(o["seconds"]) if o and o["seconds"] else None)
        residual = None
        if pred is not None and obs is not None:
            residual = pred - obs
            pred_total += pred
            obs_total += obs
            joined += 1
        rows.append({
            "key": key,
            "label": (s or o)["label"],
            "vertex": (s or o).get("vertex", key.split(":", 1)[0]),
            "flops": (s or {}).get("flops"),
            "bound": (s or {}).get("bound"),
            "predicted_seconds": pred,
            "observed_seconds": obs,
            "residual": residual,
        })
    rows.sort(key=lambda r: (r["residual"] is None,
                             -(r["observed_seconds"] or 0.0)))
    # chain-kernel spans carry their OWN predicted seconds (the unified
    # planner's kernel-axis price rides `predicted_seconds` on every
    # `chain_kernel` interval), so the kernel join needs no static
    # metadata: predicted vs the span's observed wall seconds, per
    # kernel-bearing dispatch
    kernel_rows: List[Dict[str, Any]] = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("name") != "chain_kernel":
            continue
        args = e.get("args", {})
        pred = args.get("predicted_seconds")
        obs = float(e.get("dur", 0.0) or 0.0) / 1e6
        kernel_rows.append({
            "label": args.get("label"),
            "family": args.get("family"),
            "predicted_seconds": (float(pred) if pred is not None
                                  else None),
            "observed_seconds": obs if obs else None,
            "residual": (float(pred) - obs
                         if pred is not None and obs else None),
            # the static verifier's verdict for this lowering (True
            # proved / False refuted / None unverifiable); the port has
            # no such verifier, so its spans carry None
            "statically_verified": args.get("statically_verified"),
        })
    return {
        "rows": rows,
        "kernels": kernel_rows,
        "predicted_seconds": pred_total,
        "observed_seconds": obs_total,
        "flops_residual_seconds": (
            pred_total - obs_total if joined else None),
        "stages_joined": joined,
        "machine": {k: roof.get(k) for k in ("peak_flops", "peak_bw")
                    if roof.get(k) is not None} or None,
    }


def reconcile_serving(trace: Dict[str, Any],
                      observed: Optional[Any] = None) -> Dict[str, Any]:
    """Join the trace's embedded serving certificate
    (``keystone.serving`` — the per-ladder-shape certified latency
    bounds the KP9xx certifier issued, which the executor records when
    an envelope is armed) against observed per-shape serving
    percentiles measured by a serving run.

    ``observed`` is the artifact's per-shape record list
    (``[{"batch", "chunk_shape", "p50_ms", ...}]``); when omitted it is
    read from ``keystone.serving_observed`` — a serving run may embed
    its measurements into the same trace it wrote, so one artifact carries
    both sides of the join. Each observed shape joins the certificate
    row whose ladder shape covers it (``chunk_shape`` when recorded,
    else the batch itself), and the certificate's claim is directional:
    the certified bound is an UPPER bound, so ``holds`` means
    ``predicted_bound ≥ observed p50``. The residual (bound − p50,
    always ≥ 0 while the claim holds) is the `BOUND_HEADROOM`
    recalibration feed: a persistently large residual means the
    headroom can shrink. Degrades to empty rows on partial artifacts —
    the drift report must render regardless."""
    ks = trace.get("keystone", {})
    cert = ks.get("serving") or {}
    if observed is None:
        observed = ks.get("serving_observed") or []
    by_shape: Dict[int, Dict[str, Any]] = {
        int(s["batch"]): s for s in cert.get("shapes", [])
        if s.get("batch") is not None
    }
    rows: List[Dict[str, Any]] = []
    joined = 0
    violations = 0
    residual_total = 0.0
    for o in observed:
        batch = o.get("batch")
        if batch is None:
            continue
        shape = int(o.get("chunk_shape") or batch)
        p50 = o.get("p50_ms")
        p50_s = float(p50) / 1e3 if p50 is not None else None
        c = by_shape.get(shape)
        bound = float(c["predicted_seconds"]) if c else None
        residual = holds = None
        if bound is not None and p50_s is not None:
            residual = bound - p50_s
            holds = bound >= p50_s
            joined += 1
            violations += 0 if holds else 1
            residual_total += residual
        rows.append({
            "batch": int(batch),
            "chunk_shape": shape,
            "predicted_bound_seconds": bound,
            "machine_seconds": (float(c["machine_seconds"])
                                if c and "machine_seconds" in c else None),
            "observed_p50_seconds": p50_s,
            "observed_p99_seconds": (float(o["p99_ms"]) / 1e3
                                     if o.get("p99_ms") is not None
                                     else None),
            "residual_seconds": residual,
            "holds": holds,
        })
    rows.sort(key=lambda r: (r["holds"] is None, r["batch"]))
    return {
        "rows": rows,
        "shapes_joined": joined,
        "violations": violations,
        "bound_holds": (violations == 0) if joined else None,
        "residual_seconds": residual_total if joined else None,
        "slo_seconds": cert.get("slo_seconds"),
        "certified": cert.get("certified"),
        "dominating_stage": cert.get("dominating_stage"),
    }


def format_serving_reconciliation(rec: Dict[str, Any]) -> str:
    """Text table of one serving join (the --serving rendering)."""
    lines = ["== serving reconciliation (certified bound vs observed "
             "percentiles) =="]
    if not rec["rows"]:
        lines.append("(no joined shapes — trace carries no "
                     "keystone.serving certificate or no observed "
                     "percentiles)")
        return "\n".join(lines)
    lines.append(f"{'batch':>6} {'shape':>6} {'bound':>12} {'p50':>10} "
                 f"{'residual':>10} verdict")
    for r in rec["rows"]:
        bound = (f"{r['predicted_bound_seconds'] * 1e3:9.2f} ms"
                 if r["predicted_bound_seconds"] is not None else "—")
        p50 = (f"{r['observed_p50_seconds'] * 1e3:7.2f} ms"
               if r["observed_p50_seconds"] is not None else "—")
        res = (f"{r['residual_seconds'] * 1e3:+7.2f} ms"
               if r["residual_seconds"] is not None else "—")
        verdict = ("holds" if r["holds"]
                   else "VIOLATED" if r["holds"] is not None else "unjoined")
        lines.append(f"{r['batch']:>6} {r['chunk_shape']:>6} {bound:>12} "
                     f"{p50:>10} {res:>10} {verdict}")
    verdict = ("bound holds over every joined shape" if rec["bound_holds"]
               else f"{rec['violations']} shape(s) VIOLATE the bound"
               if rec["bound_holds"] is not None else "nothing joined")
    lines.append(f"({rec['shapes_joined']} shape(s) joined — {verdict})")
    return "\n".join(lines)


# --------------------------------------------------- cost-model drift


def cost_model_drift(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Recompute the cost-weight residuals from observed span timings —
    the trace-recalibration input the unified plan optimizer's priced
    menus need. Every priced optimizer decision is priced
    by ``cost = cpu_weight·flops + mem_weight·bytes +
    network_weight·collective_bytes``; a run's node spans carry
    ``seconds`` and ``out_bytes``, so the observed seconds-per-byte over
    the run bounds the effective ``mem_weight`` (HBM + transport) the
    plan actually experienced. When the trace additionally carries the
    static roofline metadata (``keystone.roofline``), the
    per-stage FLOP counts join the same spans and imply a
    ``cpu_weight`` bound too — plus a flops-residual section
    (`reconcile_roofline`: predicted vs observed stage seconds under
    the time model). Collective bytes remain unobserved, so
    ``network_weight`` reports unmeasured and keeps its current value
    in the suggestion: one card moves no collective bytes.

    Returns ``{"rows": [{weight, current, implied, ratio}],
    "suggested": {cpu_weight, mem_weight, network_weight},
    "observed_bytes", "observed_seconds", "observed_flops", "spans",
    "roofline"}`` — ``roofline`` is the flops-residual join (None when
    the trace carries no roofline metadata or no spans matched)."""
    from ..nodes.learning import cost_model

    total_b = 0.0
    total_s = 0.0
    n = 0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") != "node":
            continue
        args = e.get("args", {})
        b = float(args.get("out_bytes", 0.0) or 0.0)
        s = float(args.get("seconds", 0.0) or 0.0)
        if b > 0 and s > 0:
            total_b += b
            total_s += s
            n += 1
    implied_mem = (total_s / total_b) if total_b else None

    # flops side: the embedded roofline joins static per-stage FLOPs
    # against the same spans' seconds — the compute half of the
    # recalibration feed
    roof = reconcile_roofline(trace)
    total_f = 0.0
    flop_s = 0.0
    for r in roof["rows"]:
        if r["residual"] is not None and r["flops"]:
            total_f += float(r["flops"])
            flop_s += float(r["observed_seconds"])
    implied_cpu = (flop_s / total_f) if total_f else None
    roofline_section = None
    if roof["stages_joined"]:
        roofline_section = {
            "stages_joined": roof["stages_joined"],
            "predicted_seconds": roof["predicted_seconds"],
            "observed_seconds": roof["observed_seconds"],
            "flops_residual_seconds": roof["flops_residual_seconds"],
        }

    current = {
        "cpu_weight": float(cost_model.CPU_WEIGHT),
        "mem_weight": float(cost_model.MEM_WEIGHT),
        "network_weight": float(cost_model.NETWORK_WEIGHT),
    }
    rows = []
    for name, implied in (("cpu_weight", implied_cpu),
                          ("mem_weight", implied_mem),
                          ("network_weight", None)):
        rows.append({
            "weight": name,
            "current": current[name],
            "implied": implied,
            "ratio": (implied / current[name]) if implied else None,
        })
    suggested = dict(current)
    if implied_mem:
        suggested["mem_weight"] = implied_mem
    if implied_cpu:
        suggested["cpu_weight"] = implied_cpu
    return {
        "rows": rows,
        "suggested": suggested,
        "observed_bytes": total_b,
        "observed_seconds": total_s,
        "observed_flops": total_f,
        "spans": n,
        "roofline": roofline_section,
    }


def drift_cost_weights(trace: Dict[str, Any]):
    """The drift report as a `nodes.learning.calibrate.CostWeights` —
    the exact type `calibrate.calibrate_cost_weights` returns, so the
    recalibration feed is drop-in for every `CostModel.cost(...)`
    consumer."""
    from ..nodes.learning.calibrate import CostWeights

    s = cost_model_drift(trace)["suggested"]
    return CostWeights(s["cpu_weight"], s["mem_weight"],
                       s["network_weight"])


def format_drift(drift: Dict[str, Any]) -> str:
    lines = ["== cost-model drift (observed span timings vs calibrated "
             "weights) =="]
    for r in drift["rows"]:
        implied = (f"{r['implied']:.3e}" if r["implied"] else "unmeasured")
        ratio = (f"×{r['ratio']:.2f}" if r["ratio"] else "—")
        lines.append(
            f"{r['weight']:<16} current={r['current']:.3e} "
            f"implied={implied:>12} drift={ratio}")
    lines.append(
        f"({drift['spans']} span(s), {_fmt(drift['observed_bytes'])} over "
        f"{drift['observed_seconds']:.4f}s)")
    roof = drift.get("roofline")
    if roof is not None:
        # the flops-residual column: the roofline time model's promise
        # vs what the joined spans actually took
        lines.append(
            f"{'flops residual':<16} "
            f"predicted={roof['predicted_seconds']:.4f}s "
            f"observed={roof['observed_seconds']:.4f}s "
            f"Δ={roof['flops_residual_seconds']:+.4f}s "
            f"({roof['stages_joined']} stage(s) joined)")
    return "\n".join(lines)


def _fmt(n: Optional[float]) -> str:
    if n is None:
        return "—"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:,.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024
    return str(n)


def format_reconciliation(rec: Dict[str, Any], top: int = 20) -> str:
    per_dev = any(r.get("static_per_device_bytes") is not None
                  for r in rec["rows"])
    dtyped = any(r.get("dtype") is not None for r in rec["rows"])
    lines = ["== static vs observed memory (KP2xx calibration) =="]
    head = f"{'node':<40} {'static':>10} {'observed':>10} {'err %':>8}"
    if dtyped:
        head += f" {'dtype':>9}"
    if per_dev:
        head += f" {'per-dev':>10}"
    lines.append(head)
    for r in rec["rows"][:top]:
        err = (f"{100 * r['rel_error']:+.1f}%"
               if r["rel_error"] is not None else "—")
        line = (
            f"{r['label'][:40]:<40} {_fmt(r['static_bytes']):>10} "
            f"{_fmt(r['observed_bytes']):>10} {err:>8}"
        )
        if dtyped:
            line += f" {(r.get('dtype') or '—')[:9]:>9}"
        if per_dev:
            line += f" {_fmt(r.get('static_per_device_bytes')):>10}"
        lines.append(line)
    sp, op_, pr = (rec["static_peak_bytes"], rec["observed_peak_bytes"],
                   rec["peak_rel_error"])
    if sp is not None or op_ is not None:
        err = f"{100 * pr:+.1f}%" if pr is not None else "—"
        line = (
            f"{'PEAK LIVE SET':<40} {_fmt(sp):>10} {_fmt(op_):>10} {err:>8}")
        if dtyped:
            line += f" {'—':>9}"
        if per_dev:
            line += f" {_fmt(rec.get('static_per_device_peak_bytes')):>10}"
        lines.append(line)
    return "\n".join(lines)
