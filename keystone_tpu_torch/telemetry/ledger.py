"""Decision ledger: every optimizer choice recorded and auditable.

Counterpart of `keystone_tpu/telemetry/ledger.py:1-703`, with JAX's
record and file formats. A decision record is a plain JSON dict:

    {"seq": n, "t": <wall>, "kind": "fusion" | "megafusion" | "cache" |
     ..., "rule": "<Rule class>", "vertices": [...], "labels": [...],
     "chosen": {...},                    # the entry the rule enforced
     "alternatives": [{...}, ...],       # the menu it beat
     "predicted": {<metric>: value},
     "enforced": true}

The port's optimizer records ``fusion`` (`workflow/fusion_rule.py`,
JAX's `fusion_rule.py:86`), ``megafusion`` and ``cache``
(`workflow/autocache.py`, JAX's `autocache.py:317-330`). ``placement``
and ``precision`` wait for the planners (ROADMAP queue 1, items 8 and
10).

Destinations, cheapest first:

  - an in-memory session list, always (decisions are rare: one per rule
    firing per optimize); `session_mark()` / `session_since()` slice a
    window;
  - with a tracer active, the trace metadata (``keystone.decisions``
    and a ``keystone.ledger_run`` header);
  - with a ledger path armed (``KEYSTONE_LEDGER``,
    `ExecutionConfig.ledger_path`; a traced run defaults to
    ``<trace>.ledger.jsonl``), one JSONL line per record after a run
    header. The header carries the port's `ExecutionConfig`, the
    platform (`nodes/learning/cost_model.py::live_platform`) and the
    switches with their environment variables (`CONFIG_ENV`), which is
    what lets ``--diff`` name a ``KEYSTONE_MEGAFUSION=0`` flip.

What a run observed joins these predictions in
`analysis/reconcile.py::reconcile_decisions`; `render_ledger` and
`diff_runs` take that reconciliation (``python -m
keystone_tpu_torch.telemetry --ledger``, ``--diff``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

LEDGER_VERSION = 1

#: decision kinds the optimizer rules emit — plus "conformance", the
#: runtime watchdog's record kind: a live apply that breached its KP903
#: certified bound (bound vs observed vs flight-dump artifact).
KINDS = ("fusion", "megafusion", "placement", "precision", "chunk",
         "cache", "kernel", "spill", "conformance")

#: the config fields a run header snapshots, with the env var that
#: flips each — the channel by which ``--diff`` names a kill-switch
#: flip ("KEYSTONE_MEGAFUSION flipped 1 -> 0") instead of only
#: observing its fallout.
CONFIG_ENV = {
    "megafusion": "KEYSTONE_MEGAFUSION",
    "sharding_planner": "KEYSTONE_SHARDING_PLANNER",
    "precision_planner": "KEYSTONE_PRECISION_PLANNER",
    "unified_planner": "KEYSTONE_UNIFIED_PLANNER",
    "concurrent_dispatch": "KEYSTONE_CONCURRENT_DISPATCH",
    "pad_chunks": "KEYSTONE_PAD_CHUNKS",
    "aot_warmup": "KEYSTONE_AOT_WARMUP",
    "overlap": "KEYSTONE_OVERLAP",
    "live_telemetry": "KEYSTONE_LIVE_TELEMETRY",
    "ooc_spill": "KEYSTONE_OOC_SPILL",
}

_LOCK = threading.Lock()
_SESSION: List[Dict[str, Any]] = []
_SESSION_CAP = 100_000  # runaway backstop; decisions are per-optimize rare
_seq = 0
_started_paths: set = set()
#: last config snapshot written to each JSONL path — when a later
#: decision runs under a different scoped config (a bench sweeping
#: plans via config_override), a fresh header line marks the boundary
#: so the file never claims one config for decisions made under another
_path_configs: Dict[str, Any] = {}
_suppress = threading.local()
#: header snapshot taken at the session's FIRST decision — the config
#: the decisions were actually made under (a scoped config_override
#: must be visible in the header, or --diff could not name the flip).
_session_header: Optional[Dict[str, Any]] = None


# ------------------------------------------------------------- activation


def resolve_ledger_path() -> Optional[str]:
    """The armed JSONL path: explicit `ExecutionConfig.ledger_path`
    (env ``KEYSTONE_LEDGER``) wins; otherwise a traced run defaults to
    a ledger alongside the trace artifact (``<trace>.ledger.jsonl``) so
    the two halves of one run travel together; None when neither is
    configured (records still reach the session list and any active
    tracer)."""
    from ..workflow.env import execution_config

    cfg = execution_config()
    if cfg.ledger_path:
        return cfg.ledger_path
    if cfg.trace_path:
        return cfg.trace_path + ".ledger.jsonl"
    return None


def ledger_active() -> bool:
    """Whether records reach a durable destination (trace metadata or a
    JSONL file). The in-memory session list is always on."""
    from .spans import current_tracer

    return current_tracer() is not None or resolve_ledger_path() is not None


@contextmanager
def suppressed():
    """Scope in which `record_decision` is a no-op — for analysis-side
    callers that re-run optimizer rules on throwaway graphs
    (`fusion_rule.megafusion_blockers`) and must not pollute the run's
    ledger with decisions no executor will enforce."""
    prev = getattr(_suppress, "on", False)
    _suppress.on = True
    try:
        yield
    finally:
        _suppress.on = prev


# ------------------------------------------------------------ the header


#: (the `ExecutionConfig` object, its header): a header is built once a
#: config, since the optimizer records several decisions a run
_header_cache: Tuple[Any, Optional[Dict[str, Any]]] = (None, None)


def run_header() -> Dict[str, Any]:
    """The run-level header: ledger version, pid, wall epoch, the trace
    path (when armed), the platform, the port's `ExecutionConfig`, and
    the switches with their environment variables (the diff channel for
    a flipped switch). Built once per config object (a scoped
    `config_override` is a new one)."""
    global _header_cache
    from dataclasses import asdict

    from ..nodes.learning.cost_model import live_platform
    from ..workflow.env import execution_config

    cfg = execution_config()
    cached_cfg, header = _header_cache
    if cached_cfg is cfg:
        return header
    header = {
        "ledger_version": LEDGER_VERSION,
        "pid": os.getpid(),
        "wall_epoch": time.time(),
        "trace_path": cfg.trace_path,
        "platform": live_platform(),
        "config": {field: bool(getattr(cfg, field)) for field in CONFIG_ENV},
        "config_env": dict(CONFIG_ENV),
        "execution_config": asdict(cfg),
    }
    _header_cache = (cfg, header)
    return header


# ------------------------------------------------------------- recording


def _jsonable(obj):
    """Deep-convert a decision payload to JSON-safe primitives: specs,
    NodeIds, dtypes, and anything else exotic degrade to ``str``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    return str(obj)


def _session_run_header() -> Dict[str, Any]:
    """The session's header: snapshotted at the first decision (the
    config the decisions ran under), freshly derived otherwise."""
    global _session_header
    with _LOCK:
        if _session_header is not None:
            return dict(_session_header)
    return run_header()


def _append_jsonl(path: str, record: Dict[str, Any],
                  header: Dict[str, Any]) -> None:
    first = False
    write_header = False
    with _LOCK:
        if path not in _started_paths:
            _started_paths.add(path)
            first = True
        if first or _path_configs.get(path) != header.get("config"):
            # a config change mid-file (scoped config_override sweeps,
            # e.g. the dispatch bench's plan matrix) gets its own
            # header line: decisions are never filed under a config
            # they were not made with
            _path_configs[path] = header.get("config")
            write_header = True
    mode = "w" if first else "a"
    with open(path, mode) as f:
        if write_header:
            f.write(json.dumps(header) + "\n")
        f.write(json.dumps(record) + "\n")


def record_decision(
    kind: str,
    rule: str,
    vertices: List[int],
    labels: List[str],
    chosen: Dict[str, Any],
    alternatives: List[Dict[str, Any]],
    predicted: Dict[str, Any],
    enforced: bool = True,
) -> Optional[Dict[str, Any]]:
    """Record one optimizer decision. Never raises — a ledger bug must
    not break optimization — and returns the recorded dict (None when
    suppressed)."""
    if getattr(_suppress, "on", False):
        return None
    global _seq, _session_header
    try:
        header = run_header()
        with _LOCK:
            _seq += 1
            seq = _seq
            if _session_header is None:
                _session_header = header
        rec = {
            "seq": seq,
            "t": time.time(),
            "kind": str(kind),
            "rule": str(rule),
            "vertices": _jsonable(list(vertices)),
            "labels": _jsonable(list(labels)),
            "chosen": _jsonable(chosen),
            "alternatives": _jsonable(list(alternatives)),
            "predicted": _jsonable(predicted),
            "enforced": bool(enforced),
        }
        with _LOCK:
            _SESSION.append(rec)
            if len(_SESSION) > _SESSION_CAP:
                del _SESSION[: len(_SESSION) - _SESSION_CAP]
        from .spans import current_tracer

        tracer = current_tracer()
        if tracer is not None:
            tracer.metadata.setdefault("ledger_run", header)
            headers = tracer.metadata.setdefault("ledger_headers", [header])
            if headers[-1].get("config") != header.get("config"):
                headers.append(header)  # config changed mid-trace
            tracer.metadata.setdefault("decisions", []).append(rec)
        path = resolve_ledger_path()
        if path:
            try:
                _append_jsonl(path, rec, header)
            except OSError:
                pass  # an unwritable path must never break optimization
        return rec
    except Exception:
        return None


# ---------------------------------------------------------- session audit


def session_mark() -> int:
    """Opaque cursor into the in-memory session list; pair with
    `session_since` to slice the decisions of one measured window."""
    with _LOCK:
        return len(_SESSION)


def session_since(mark: int) -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_SESSION[mark:])


def session_decisions() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_SESSION)


def clear_session() -> None:
    """Drop the in-memory session records (tests; a fresh bench tier).
    JSONL files and trace metadata are untouched."""
    global _seq, _session_header
    with _LOCK:
        _SESSION.clear()
        _seq = 0
        _session_header = None


def write_session(path: str, decisions: Optional[List[Dict]] = None,
                  header: Optional[Dict[str, Any]] = None) -> str:
    """Write a complete ledger file (header + decisions) in one shot —
    the explicit-flush form for tests and hosts that manage lifecycle
    themselves (the ambient JSONL path appends incrementally instead).
    The default header is the session's first-decision snapshot, so a
    scoped config override active during the run is what the file
    records; callers slicing one window out of a longer session pass
    the `run_header()` they captured inside that window."""
    with open(path, "w") as f:
        f.write(json.dumps(_jsonable(
            _session_run_header() if header is None else header)) + "\n")
        for rec in (session_decisions() if decisions is None else decisions):
            f.write(json.dumps(_jsonable(rec)) + "\n")
    return path


# --------------------------------------------------------------- reading


def read_ledger(path: str) -> Dict[str, Any]:
    """Load a run's decisions from either artifact form:

      - a ledger JSONL (header line + one record per line), or
      - a Chrome trace JSON whose ``keystone`` metadata embeds
        ``ledger_run`` + ``decisions`` (and, as a bonus, the
        observations reconciliation needs).

    Returns ``{"path", "header", "headers", "decisions", "trace"}`` —
    ``header`` is the run's first header, ``headers`` every header line
    (a run whose config changed mid-file — scoped overrides sweeping
    plans — carries one per config), and ``trace`` is the parsed trace
    object when one is available (the trace form itself, or the
    header's ``trace_path`` when that file exists), else None. A
    truncated final JSONL line (a run killed mid-append) is dropped:
    the parseable prefix IS the contract; corruption anywhere else
    still raises."""
    with open(path) as f:
        text = f.read()
    header: Dict[str, Any] = {}
    headers: List[Dict[str, Any]] = []
    decisions: List[Dict[str, Any]] = []
    trace = None
    parsed = None
    try:
        parsed = json.loads(text)
    except ValueError:
        parsed = None
    if isinstance(parsed, dict) and "traceEvents" in parsed:
        ks = parsed.get("keystone", {})
        header = ks.get("ledger_run") or {}
        headers = list(ks.get("ledger_headers") or ([header] if header
                                                    else []))
        decisions = list(ks.get("decisions") or [])
        trace = parsed
    else:
        lines = [ln.strip() for ln in text.splitlines()]
        lines = [ln for ln in lines if ln]
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    break  # truncated tail from a killed run
                raise
            if "ledger_version" in rec and "kind" not in rec:
                headers.append(rec)
            else:
                decisions.append(rec)
        header = headers[0] if headers else {}
        tp = header.get("trace_path")
        if tp and os.path.exists(tp):
            try:
                from .export import load_trace

                trace = load_trace(tp)
            except (OSError, ValueError):
                trace = None
    return {"path": path, "header": header, "headers": headers,
            "decisions": decisions, "trace": trace}


# ------------------------------------------------------------- rendering


def runner_up(record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The best-priced alternative the chosen entry beat: lowest value
    of the first ``cost_*`` field present, else the first alternative."""
    alts = record.get("alternatives") or []
    if not alts:
        return None
    cost_keys = [k for k in alts[0] if str(k).startswith("cost_")]
    if cost_keys:
        key = cost_keys[0]
        priced = [a for a in alts if isinstance(a.get(key), (int, float))]
        if priced:
            return min(priced, key=lambda a: a[key])
    return alts[0]


def _short(d: Optional[Dict[str, Any]], width: int = 34) -> str:
    if not d:
        return "—"
    entry = d.get("entry")
    if entry is None:
        entry = ", ".join(f"{k}={v}" for k, v in sorted(d.items())
                          if not isinstance(v, (dict, list)))
    return str(entry)[:width]


def render_ledger(run: Dict[str, Any],
                  reconciliation: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable per-decision table: chosen / runner-up /
    predicted — plus observed / residual columns when a reconciliation
    (from `analysis.reconcile.reconcile_decisions`) is supplied."""
    lines: List[str] = []
    header = run.get("header") or {}
    cfg = header.get("config") or {}
    if cfg:
        flags = " ".join(f"{k}={'1' if v else '0'}"
                         for k, v in sorted(cfg.items()))
        lines.append(f"run config: {flags}")
    decisions = run.get("decisions") or []
    lines.append(f"{len(decisions)} decision(s)")
    obs_by_seq: Dict[Any, Dict[str, Any]] = {}
    if reconciliation:
        for row in reconciliation.get("rows", []):
            obs_by_seq[row.get("seq")] = row
    head = (f"{'kind':<11} {'decision':<34} {'chosen':<26} "
            f"{'runner-up':<26} {'predicted':<30}")
    if reconciliation:
        head += f" {'observed':<24} {'residual':<18}"
    lines.append(head)
    for d in decisions:
        labels = d.get("labels") or []
        name = (labels[0] if labels else "?")
        if len(labels) > 1:
            name += f" (+{len(labels) - 1})"
        pred = d.get("predicted") or {}
        pred_s = " ".join(
            f"{k}={_fmt_val(v)}" for k, v in sorted(pred.items())
            if not isinstance(v, (dict, list)))
        line = (f"{d.get('kind', '?'):<11} {name[:34]:<34} "
                f"{_short(d.get('chosen'), 26):<26} "
                f"{_short(runner_up(d), 26):<26} {pred_s[:30]:<30}")
        if reconciliation:
            row = obs_by_seq.get(d.get("seq")) or {}
            obs = row.get("observed") or {}
            res = row.get("residuals") or {}
            obs_s = " ".join(f"{k}={_fmt_val(v)}"
                             for k, v in sorted(obs.items()))
            res_s = " ".join(f"{k}={_fmt_val(v)}"
                             for k, v in sorted(res.items()))
            line += f" {obs_s[:24]:<24} {res_s[:18]:<18}"
        lines.append(line)
    return "\n".join(lines)


def _fmt_val(v) -> str:
    if isinstance(v, float) and v == int(v):
        v = int(v)
    if isinstance(v, int) and abs(v) >= 10_000:
        return f"{v:,}"
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


# ------------------------------------------------------------------ diff


def decision_key(record: Dict[str, Any]) -> Tuple[str, str]:
    """Run-over-run identity of a decision: its kind plus its label
    trail (vertex ids are per-graph and shift between runs; labels are
    the stable anchor, matching the reconcile-table convention)."""
    return (str(record.get("kind")),
            ";".join(str(x) for x in record.get("labels") or []))


#: relative tolerance for "the prediction drifted" (predictions are
#: priced integers; a 1% wobble from a count change is not drift).
DRIFT_RTOL = 0.01


def diff_runs(
    run_a: Dict[str, Any],
    run_b: Dict[str, Any],
    reconciliation_a: Optional[Dict[str, Any]] = None,
    reconciliation_b: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Run-over-run regression detection. Returns a dict with:

      - ``config_flips`` — optimizer-config fields (and their env-var
        names) that changed between the two run headers: an injected
        ``KEYSTONE_MEGAFUSION=0`` is named here directly;
      - ``decisions_removed`` / ``decisions_added`` — decision keys
        present in one run only (a kill switch removes its rule's
        decisions; a new rule adds some);
      - ``prediction_drift`` — same decision key, numeric predicted
        values differing beyond `DRIFT_RTOL`;
      - ``observed_regressions`` — per shared observed metric of the
        two reconciliations, run B strictly worse than run A (programs
        and bytes are both better-smaller);
      - ``regressions`` — the total count the CLI exits nonzero on.
    """
    header_a = run_a.get("header") or {}
    cfg_a = _stable_config(run_a)
    cfg_b = _stable_config(run_b)
    env_names = dict(CONFIG_ENV)
    env_names.update(header_a.get("config_env") or {})
    config_flips = []
    for field in sorted(set(cfg_a) | set(cfg_b)):
        va, vb = cfg_a.get(field), cfg_b.get(field)
        if va != vb and va is not None and vb is not None:
            config_flips.append({
                "field": field,
                "env": env_names.get(field, field),
                "a": va, "b": vb,
            })

    by_key_a: Dict[Tuple[str, str], Dict] = {}
    by_key_b: Dict[Tuple[str, str], Dict] = {}
    for rec in run_a.get("decisions") or []:
        by_key_a.setdefault(decision_key(rec), rec)
    for rec in run_b.get("decisions") or []:
        by_key_b.setdefault(decision_key(rec), rec)

    removed = [
        {"kind": k[0], "labels": k[1],
         "suspect_env": _suspect_env(k[0], config_flips)}
        for k in sorted(set(by_key_a) - set(by_key_b))
    ]
    added = [{"kind": k[0], "labels": k[1]}
             for k in sorted(set(by_key_b) - set(by_key_a))]

    drift = []
    for key in sorted(set(by_key_a) & set(by_key_b)):
        pa = by_key_a[key].get("predicted") or {}
        pb = by_key_b[key].get("predicted") or {}
        for metric in sorted(set(pa) & set(pb)):
            va, vb = pa[metric], pb[metric]
            if not isinstance(va, (int, float)) \
                    or not isinstance(vb, (int, float)):
                continue
            tol = DRIFT_RTOL * max(abs(va), abs(vb), 1.0)
            if abs(va - vb) > tol:
                drift.append({
                    "kind": key[0], "labels": key[1], "metric": metric,
                    "a": va, "b": vb,
                })

    observed_regressions = _observed_regressions(
        reconciliation_a, reconciliation_b)

    regressions = (len(config_flips) + len(removed) + len(drift)
                   + len(observed_regressions))
    return {
        "config_flips": config_flips,
        "decisions_removed": removed,
        "decisions_added": added,
        "prediction_drift": drift,
        "observed_regressions": observed_regressions,
        "regressions": regressions,
    }


def _stable_config(run: Dict[str, Any]) -> Dict[str, Any]:
    """The config fields that held ONE value for the whole run. A file
    whose config changed mid-run (scoped overrides sweeping plans)
    carries several headers; a field that varied within the run cannot
    be flip-compared against another run, so it is dropped here — only
    genuinely run-constant fields feed ``config_flips``."""
    headers = run.get("headers") or []
    if not headers and run.get("header"):
        headers = [run["header"]]
    configs = [h.get("config") or {} for h in headers]
    configs = [c for c in configs if c]
    if not configs:
        return {}
    stable = dict(configs[0])
    for cfg in configs[1:]:
        for field in list(stable):
            if cfg.get(field, object()) != stable[field]:
                del stable[field]
    return stable


#: which config switch owns which decision kind: how a removed
#: decision is attributed to the flip that removed it (fusion has no
#: switch of its own; placement and precision have two owners, the
#: sequential rule's switch and the unified planner's, `:612-629`).
_KIND_FIELDS = {
    "megafusion": ("megafusion",),
    "placement": ("sharding_planner", "unified_planner"),
    "precision": ("precision_planner", "unified_planner"),
    "chunk": ("unified_planner",),
    "cache": ("unified_planner",),
    "kernel": ("unified_planner",),
    "spill": ("ooc_spill", "unified_planner"),
    "conformance": ("live_telemetry",),
}


def _suspect_env(kind: str, config_flips: List[Dict]) -> Optional[str]:
    """The kill switch to blame for a removed decision — only when an
    owning config field ACTUALLY flipped between the runs; a decision
    that vanished under identical config (pipeline edit, savings floor)
    names no suspect."""
    fields = _KIND_FIELDS.get(kind)
    if not fields:
        return None
    for field in fields:
        for flip in config_flips:
            if flip.get("field") == field:
                return flip.get("env", field)
    return None


#: observed metrics where smaller is better (a B>A move is a
#: regression); everything else is reported as drift only. Names match
#: `analysis.reconcile.reconcile_decisions`'s observed keys.
_SMALLER_BETTER = (
    "programs_executed", "programs_compiled", "megafused_programs",
    "boundary_bytes", "out_bytes", "casts_baked",
)


def _observed_regressions(rec_a, rec_b) -> List[Dict[str, Any]]:
    if not rec_a or not rec_b:
        return []

    def totals(rec):
        out: Dict[str, float] = {}
        for row in rec.get("rows", []):
            for metric, v in (row.get("observed") or {}).items():
                if isinstance(v, (int, float)):
                    out[metric] = out.get(metric, 0.0) + v
        # run-level observations live on the reconciliation itself
        for metric, v in (rec.get("run_observed") or {}).items():
            if isinstance(v, (int, float)):
                out.setdefault(metric, v)
        return out

    ta, tb = totals(rec_a), totals(rec_b)
    out = []
    for metric in sorted(set(ta) & set(tb)):
        if metric not in _SMALLER_BETTER:
            continue
        if tb[metric] > ta[metric]:
            out.append({"metric": metric, "a": ta[metric], "b": tb[metric]})
    return out


def format_diff(diff: Dict[str, Any]) -> str:
    lines: List[str] = []
    for f in diff["config_flips"]:
        lines.append(
            f"CONFIG FLIP: {f['env']} ({f['field']}) "
            f"{'1' if f['a'] else '0'} -> {'1' if f['b'] else '0'}")
    for d in diff["decisions_removed"]:
        sus = f" (suspect: {d['suspect_env']})" if d.get("suspect_env") \
            else ""
        lines.append(
            f"DECISION REMOVED: {d['kind']} [{d['labels'][:60]}]{sus}")
    for d in diff["decisions_added"]:
        lines.append(f"decision added: {d['kind']} [{d['labels'][:60]}]")
    for d in diff["prediction_drift"]:
        lines.append(
            f"PREDICTION DRIFT: {d['kind']} [{d['labels'][:40]}] "
            f"{d['metric']}: {_fmt_val(d['a'])} -> {_fmt_val(d['b'])}")
    for d in diff["observed_regressions"]:
        lines.append(
            f"OBSERVED REGRESSION: {d['metric']} "
            f"{_fmt_val(d['a'])} -> {_fmt_val(d['b'])} (worse)")
    lines.append(f"{diff['regressions']} regression(s)")
    return "\n".join(lines)
