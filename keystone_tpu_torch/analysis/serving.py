"""Static serving-readiness certifier: the KP9xx tier.

Counterpart of `keystone_tpu/analysis/serving.py:1-1002`. Given a fitted
(or ``analyzable()``) pipeline and a declared serving envelope (batch
range, SLO, tenants), the pass proves, or names the stage that breaks,
each leg of the serving claim before any traffic arrives:

  - **KP901 (error)**: an apply-path stage that cannot run on meta
    tensors (host code: its body needs values, ``.item()``, ``.cpu()``,
    ``.numpy()``; or no propagated element spec reaches it). It can be
    neither warmed nor captured into the megafused chunk loop. The fix
    is named per stage: a device body, or a declared serving-ingress
    spec (`SERVING_INGRESS`, seeded through ``spec_pass(seeds=...)``).
  - **KP902**: warm coverage. Every pad-ladder shape the envelope can
    produce (`ladder_shapes`, the image of `utils/batching._pad_target`)
    is enumerated against the warmable fused program sites. Apply-path
    device stages outside every site run cold at each shape (WARNING);
    where `warmup_manifest` covers everything the finding is INFO. On
    the card "cold" means a kernel build, a launch-plan build or a CUDA
    graph capture; `workflow/executor.py::warm_fitted_manifest` does
    them all before traffic.
  - **KP903**: the certified latency bound a ladder shape:
    ``BOUND_HEADROOM × Σ roofline seconds`` plus a floor a program and a
    floor an apply (ERROR when the worst shape busts the SLO, with the
    dominating stage named). Each row also carries the machine bound
    (raw roofline seconds plus ``DISPATCH_OVERHEAD_S`` a program).
  - **KP904 (error)**: an apply-path operator that writes into the
    pipeline's own input tensor in place (``donates_deps``): a serving
    caller keeps the request it passed.
  - **KP905**: residency: per-device peak bytes × the envelope's tenants
    against the device memory budget.
  - **KP906 (warning)**: an apply-path operator's hot method that formats
    a telemetry metric name dynamically (unbounded registry cardinality).

``BOUND_HEADROOM``, ``PROGRAM_FLOOR_S``, ``APPLY_FLOOR_S`` (`:85-115`)
and `roofline.DISPATCH_OVERHEAD_S` are the JAX package's model, fitted
to XLA program dispatch on its platforms; the port copies them so that
its certificates equal JAX's. They are not measurements of the card:
`chip_smoke.py`'s serving phase prints the card's observed latencies a
rung beside these bounds.

Surfaces: ``Pipeline.validate(serving=ServingEnvelope(...))`` (or
``KEYSTONE_SLO_MS``) puts the `ServingCertificate` on
``report.serving``; the executor embeds it as ``serving`` trace metadata
under a tracer with an envelope armed, and arms the watchdog from it;
the ledger records one ``serving_cert`` decision a certification. Pure
spec arithmetic: no data loads and nothing launches.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..workflow.graph import Graph, GraphId, NodeId, SinkId, SourceId
from .diagnostics import Diagnostic, Severity
from .memory import _fmt_bytes, resolve_chunk_rows
from .propagate import _label, toposort
from .roofline import DISPATCH_OVERHEAD_S, roofline_pass
from .specs import DataSpec, is_known, shape_struct

# ------------------------------------------------------------- constants

#: default SLO when an envelope is armed without one (seconds).
DEFAULT_SLO_S = 1.0

#: default micro-batch coalescing window: the largest request batch the
#: serving runtime's pad ladder is certified for when the envelope does
#: not declare one.
DEFAULT_MAX_BATCH = 64

#: roofline-to-certified-bound guardband: the JAX package's model (XLA
#: reaching a single-digit percent of the analytic peaks at serving
#: batch sizes), not a card measurement
BOUND_HEADROOM = 48.0

#: per-program floor of the certified bound: the JAX package's model of
#: XLA dispatch plus the executor's force path a program
PROGRAM_FLOOR_S = 1e-3

#: per-apply floor: the JAX package's model of one request's graph bind
#: and force, fitted to its CPU-tier observations
APPLY_FLOOR_S = 1e-2


# -------------------------------------------------------------- envelope


@dataclass(frozen=True)
class ServingEnvelope:
    """The declared serving contract a certificate is issued against:
    request batches in ``[min_batch, max_batch]`` (coalesced onto the pad
    ladder), a latency SLO in seconds, and the number of concurrently
    warmed pipelines sharing the device (KP905)."""

    min_batch: int = 1
    max_batch: int = DEFAULT_MAX_BATCH
    slo_seconds: float = DEFAULT_SLO_S
    tenants: int = 1

    def __post_init__(self):
        if self.min_batch < 1 or self.max_batch < self.min_batch:
            raise ValueError(
                f"batch range [{self.min_batch}, {self.max_batch}] is empty")
        if self.slo_seconds <= 0:
            raise ValueError("slo_seconds must be positive")
        if self.tenants < 1:
            raise ValueError("tenants must be >= 1")


def envelope_from_env(require_slo: bool = True) -> Optional[ServingEnvelope]:
    """The env-declared envelope, or None when serving certification is
    not armed. ``KEYSTONE_SLO_MS`` arms it (the SLO in milliseconds);
    ``KEYSTONE_SERVING_MAX_BATCH`` / ``KEYSTONE_SERVING_TENANTS``
    refine the batch range and tenancy. A malformed value disarms
    rather than breaking validation. ``require_slo=False`` always
    returns an envelope: the refinement variables are honored without
    ``KEYSTONE_SLO_MS``, and malformed fields degrade to their
    defaults."""
    raw = os.environ.get("KEYSTONE_SLO_MS")
    if raw:
        try:
            return ServingEnvelope(
                max_batch=int(os.environ.get(
                    "KEYSTONE_SERVING_MAX_BATCH", str(DEFAULT_MAX_BATCH))),
                slo_seconds=float(raw) / 1e3,
                tenants=int(os.environ.get("KEYSTONE_SERVING_TENANTS", "1")),
            )
        except (TypeError, ValueError):
            if require_slo:
                return None
    if require_slo:
        return None

    def _int(var: str, default: int) -> int:
        try:
            return int(os.environ.get(var, ""))
        except (TypeError, ValueError):
            return default

    try:
        return ServingEnvelope(
            max_batch=_int("KEYSTONE_SERVING_MAX_BATCH", DEFAULT_MAX_BATCH),
            tenants=_int("KEYSTONE_SERVING_TENANTS", 1))
    except ValueError:
        return ServingEnvelope()


def ladder_shapes(envelope: ServingEnvelope,
                  chunk_rows: Optional[int] = None) -> List[int]:
    """Every padded leading dim the envelope can produce, the image of
    `utils.batching._pad_target` over the batch range: the power-of-two
    ladder up to the chunk size, then the chunk size itself. These are
    the rungs warm serving must cover."""
    from ..utils.batching import _pad_target

    chunk = resolve_chunk_rows(chunk_rows)
    lo = max(1, int(envelope.min_batch))
    hi = max(lo, int(envelope.max_batch))
    shapes = {_pad_target(lo, chunk, lo)}
    p = 1 << max(0, lo - 1).bit_length()  # pow-2 ceiling of lo
    while p < min(hi, chunk):
        p <<= 1
        shapes.add(min(chunk, p))
    if hi >= chunk:
        shapes.add(chunk)
    return sorted(shapes)


# ---------------------------------------------------- example registries

#: declared serving-ingress boundaries: examples whose TRAINING source
#: is opaque host objects (labeled images) but whose serving requests
#: are fixed-shape arrays. The named stage's output is seeded with the
#: declared element (``spec_pass(seeds=...)`` — a seed only fills what
#: propagation could not know), so the device apply path downstream of
#: the ingress is priced and certified; the certificate names the
#: boundary it was issued at.
SERVING_INGRESS: Dict[str, Dict[str, Any]] = {
    "VOCSIFTFisher": {
        "stage": "MultiLabeledImageExtractor",
        "shape": (96, 96, 3),
        "dtype": "float32",
        "note": "requests enter as decoded fixed-size images; the "
                "label-extract wrapper is train-time plumbing",
    },
    "ImageNetSiftLcsFV": {
        "stage": "_Image",
        "shape": (64, 64, 3),
        "dtype": "float32",
        "note": "requests enter as decoded fixed-size images; the "
                "label-extract wrapper is train-time plumbing",
    },
}

#: named per-example suppressions for pipelines that cannot certify yet:
#: rule id -> the stage-level rationale and the fix (the JAX package's
#: text, whose bounds are its own model's numbers)
SERVING_SUPPRESSIONS: Dict[str, Dict[str, str]] = {
    "VOCSIFTFisher": {
        "KP903": "the worst in-envelope shape (batch 64) prices over the "
                 "1 s default SLO under the JAX package's headroom model, "
                 "dominated by SIFTExtractor (the dense multi-scale "
                 "descriptor grid). Fix: serve it with max_batch 32, "
                 "which certifies",
    },
    "NewsgroupsPipeline": {
        "KP901": "the NLP front-end (Trim >> LowerCase >> Tokenizer >> "
                 "NGramsFeaturizer >> TermFrequency) is host string code "
                 "by design. Fix: `serving.TextIngress` runs it a "
                 "request at ingress, and the runtime serves the device "
                 "tail (`serving.split_fitted_at`)",
    },
}


# ------------------------------------------------------------ apply path


def _is_host_stage(graph: Graph, vid: NodeId, specs: Dict) -> bool:
    """A provable host-code stage (`keystone_tpu/analysis/sharding.py:
    228-253`, copied here until the sharding tier is ported): a plain
    transformer whose meta run died on host code (known input elements,
    UNKNOWN output element) or whose output spec says host. Delegates and
    estimators are excluded: a delegate's fitted transformer is
    unknowable, not provably host."""
    from ..workflow.operators import (
        DelegatingOperator,
        EstimatorOperator,
        TransformerOperator,
    )

    op = graph.get_operator(vid)
    if isinstance(op, (DelegatingOperator, EstimatorOperator)):
        return False
    if not isinstance(op, TransformerOperator):
        return False
    out = specs.get(vid)
    if isinstance(out, DataSpec) and not out.on_device:
        return True
    in_specs = [specs.get(d) for d in graph.get_dependencies(vid)]
    data_in = [s for s in in_specs if isinstance(s, DataSpec)]
    if not data_in or not all(is_known(s.element) for s in data_in):
        return False
    return isinstance(out, DataSpec) and not is_known(out.element)



def apply_path(graph: Graph, source: Optional[SourceId] = None,
               sink: Optional[SinkId] = None) -> List[NodeId]:
    """The serving apply path: the vertices a request flows through,
    descendants of the pipeline input that reach the sink, in
    topological order. With no unbound source (a bound or fitted graph)
    every sink ancestor is on it."""
    from ..workflow.analysis import ancestors, descendants

    order, _ = toposort(graph)
    sinks = [sink] if sink is not None else sorted(graph.sink_ids)
    anc: set = set()
    for s in sinks:
        anc |= ancestors(graph, s)
        anc.add(graph.get_sink_dependency(s))
    sources = [source] if source is not None else sorted(graph.sources)
    if sources:
        desc: set = set()
        for s in sources:
            desc |= descendants(graph, s)
        anc &= desc
    return [v for v in order if v in anc and isinstance(v, NodeId)]


def ingress_seeds(graph: Graph, name: Optional[str],
                  count: int = 64) -> Tuple[Dict[NodeId, DataSpec],
                                            Optional[Dict[str, Any]]]:
    """The `SERVING_INGRESS` seed map for one registered example: every
    vertex whose operator label matches the declared ingress stage
    (training-branch copies included, so the fits see the declared
    element). Returns ``(seeds, ingress_decl)``; empty for examples with
    no declared ingress."""
    decl = SERVING_INGRESS.get(name or "")
    if not decl:
        return {}, None
    elem = shape_struct(decl["shape"], decl["dtype"])
    seeds = {
        vid: DataSpec(element=elem, count=count)
        for vid in graph.operators
        if graph.get_operator(vid).label == decl["stage"]
    }
    return seeds, decl


# ------------------------------------------------------- warmup manifest


def _fused_plan(graph: Graph):
    """The fused projection of ``graph``: the plan whose fused operators
    are the executor's warmable program sites, made by the rules the
    default optimizer runs (node fusion, then megafusion where it is on)
    on a throwaway copy. Fitted graphs already carry fused transformers.
    Kept out of the ledger: no executor enforces this rewrite."""
    from ..telemetry import ledger
    from ..workflow.env import execution_config
    from ..workflow.fusion_rule import MegafusionRule, NodeFusionRule

    with ledger.suppressed():
        plan = NodeFusionRule().apply((graph, {}))
        if execution_config().megafusion:
            plan = MegafusionRule().apply(plan)
        return plan[0]


def _is_warm_target(op) -> bool:
    from ..nodes.util.fusion import FusedBatchTransformer
    from ..workflow.fusion_rule import FusedChainOperator

    return isinstance(op, (FusedBatchTransformer, FusedChainOperator))


def _manifest_entries(fused: Graph, specs: Dict[GraphId, Any],
                      counts: List[int],
                      path: Optional[set] = None
                      ) -> Tuple[List[Dict[str, Any]], set]:
    """One manifest entry per warmable fused program site whose input
    spec is a known dataset: the one enumeration behind
    `warmup_manifest()` (what the executor warms) and KP902's coverage,
    so the two cannot drift. ``path`` restricts to apply-path vertices.
    Returns ``(entries, covered_vertex_ids)``."""
    entries: List[Dict[str, Any]] = []
    covered: set = set()
    for vid in sorted(fused.operators, key=lambda n: n.id):
        op = fused.get_operator(vid)
        if not _is_warm_target(op):
            continue
        if path is not None and vid not in path:
            continue
        deps = fused.get_dependencies(vid)
        if not deps:
            continue
        data_spec = specs.get(deps[-1])
        if not (isinstance(data_spec, DataSpec)
                and data_spec.kind == "dataset"
                and is_known(data_spec.element)):
            continue
        entries.append({
            "vertex": vid.id,
            "label": op.label,
            "element": data_spec.element,
            "counts": list(counts),
        })
        covered.add(vid)
    return entries, covered


def warmup_manifest(
    graph: Graph,
    source_specs: Optional[Dict] = None,
    *,
    envelope: Optional[ServingEnvelope] = None,
    chunk_rows: Optional[int] = None,
    seeds: Optional[Dict[NodeId, DataSpec]] = None,
) -> List[Dict[str, Any]]:
    """The warm-up enumeration for an envelope: one entry per warmable
    fused program site with its input element spec and every pad-ladder
    count the envelope can produce. `GraphExecutor.warm_manifest` takes
    it (and `_warm_plan` the same counts when ``KEYSTONE_SLO_MS`` is
    armed), so warm serving at any in-envelope shape captures nothing
    and builds nothing."""
    from .propagate import spec_pass

    envelope = envelope or envelope_from_env() or ServingEnvelope()
    counts = ladder_shapes(envelope, chunk_rows)
    fused = _fused_plan(graph)
    specs, _ = spec_pass(fused, source_specs, seeds=seeds)
    entries, _ = _manifest_entries(fused, specs, counts)
    return entries


# --------------------------------------------------- KP906 (cardinality)

_METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})
#: attribute-call receivers that resolve to this repo's metrics
#: registry; `np.histogram` and `torch.histogram` must never match
_METRIC_RECEIVERS = frozenset({"telemetry", "metrics", "registry"})


def _is_metric_factory(func: ast.AST) -> bool:
    """Is this call expression a telemetry metric factory? Bare names
    (``counter(...)`` imported from telemetry, underscore aliases) and
    attribute calls whose receiver is the telemetry module / a
    ``registry()`` call; `np.histogram`-style attribute calls on other
    receivers are not metrics."""
    if isinstance(func, ast.Name):
        return func.id.lstrip("_") in _METRIC_FACTORIES
    if isinstance(func, ast.Attribute):
        if func.attr.lstrip("_") not in _METRIC_FACTORIES:
            return False
        recv = func.value
        if isinstance(recv, ast.Name):
            return recv.id.lstrip("_") in _METRIC_RECEIVERS
        if isinstance(recv, ast.Call) and isinstance(recv.func, ast.Name):
            return recv.func.id.lstrip("_") == "registry"
        return False
    return False


def _dynamic_metric_sites(cls: type) -> List[Tuple[str, int]]:
    """``(method, lineno)`` sites in this operator class's hot methods
    where a telemetry metric factory is called with a non-literal name:
    per-request names mint unbounded registry cardinality. The walk
    covers the operator classes a plan instantiates, wherever they come
    from."""
    from .effects import HOT_METHODS, _class_defn, _suppressed

    defn = _class_defn(cls)
    if defn is None:
        return []
    cls_node, lines = defn
    out: List[Tuple[str, int]] = []
    for fn in cls_node.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in HOT_METHODS:
            continue
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if not _is_metric_factory(func):
                continue
            arg = sub.args[0] if sub.args else None
            if arg is None:
                for kw in sub.keywords:
                    if kw.arg == "name":
                        arg = kw.value
                        break
            if arg is None or (isinstance(arg, ast.Constant)
                               and isinstance(arg.value, str)):
                continue
            if _suppressed(lines, sub.lineno, "KP906"):
                continue
            out.append((fn.name, sub.lineno))
    return out


# ------------------------------------------------------- the certificate


@dataclass
class ServingCertificate:
    """One pipeline's serving verdict: the envelope it was issued
    against, the per-shape certified latency bounds, the warmup
    manifest, and the apply-path accounting the KP9xx findings came
    from. ``certified`` means no ERROR-severity KP9xx finding."""

    envelope: ServingEnvelope
    shapes: List[Dict[str, Any]] = field(default_factory=list)
    per_item_seconds: float = 0.0
    programs: int = 0
    priced_stages: int = 0
    unpriced_stages: int = 0
    dominating_stage: Optional[str] = None
    manifest: List[Dict[str, Any]] = field(default_factory=list)
    exposed_stages: List[str] = field(default_factory=list)
    per_device_peak_bytes: Optional[int] = None
    ingress: Optional[Dict[str, Any]] = None
    certified: bool = False

    @property
    def worst_shape(self) -> Optional[Dict[str, Any]]:
        return max(self.shapes, default=None,
                   key=lambda s: s["predicted_seconds"])

    def as_record(self) -> Dict[str, Any]:
        """The JSON and trace-metadata (``serving``) form: what the
        watchdog arms from (`telemetry/watchdog.py::from_certificate`)."""
        return {
            "certified": self.certified,
            "slo_seconds": self.envelope.slo_seconds,
            "min_batch": self.envelope.min_batch,
            "max_batch": self.envelope.max_batch,
            "tenants": self.envelope.tenants,
            "per_item_seconds": self.per_item_seconds,
            "programs": self.programs,
            "priced_stages": self.priced_stages,
            "unpriced_stages": self.unpriced_stages,
            "dominating_stage": self.dominating_stage,
            "exposed_stages": list(self.exposed_stages),
            "per_device_peak_bytes": self.per_device_peak_bytes,
            "ingress": dict(self.ingress) if self.ingress else None,
            "shapes": [dict(s) for s in self.shapes],
            "warmup_manifest": [
                {"vertex": e["vertex"], "label": e["label"],
                 "counts": list(e["counts"])}
                for e in self.manifest
            ],
        }

    def __repr__(self) -> str:
        verdict = "certified" if self.certified else "UNCERTIFIED"
        worst = self.worst_shape
        bound = (f", worst shape {worst['batch']} ≈ "
                 f"{worst['predicted_seconds'] * 1e3:.1f}ms"
                 if worst else "")
        return (f"ServingCertificate({verdict}, "
                f"{len(self.shapes)} ladder shape(s){bound}, "
                f"SLO {self.envelope.slo_seconds * 1e3:.0f}ms)")


def shape_bound(per_item_seconds: float, batch: int,
                programs: int) -> Tuple[float, float]:
    """``(certified_seconds, machine_seconds)`` for one ladder shape: the
    machine bound is the raw roofline sum plus ``DISPATCH_OVERHEAD_S`` a
    program; the certified bound multiplies the roofline by
    `BOUND_HEADROOM` and adds the floors a program and an apply."""
    roofline = per_item_seconds * batch
    machine = roofline + programs * DISPATCH_OVERHEAD_S
    certified = (BOUND_HEADROOM * roofline
                 + programs * PROGRAM_FLOOR_S + APPLY_FLOOR_S)
    return certified, machine


# --------------------------------------------------------------- the pass


def serving_pass(
    graph: Graph,
    specs: Dict[GraphId, Any],
    envelope: Optional[ServingEnvelope] = None,
    *,
    source: Optional[SourceId] = None,
    sink: Optional[SinkId] = None,
    memory=None,
    roofline=None,
    hbm_budget_bytes: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    label: Optional[str] = None,
    ingress: Optional[Dict[str, Any]] = None,
    seeds: Optional[Dict[NodeId, DataSpec]] = None,
    record: bool = True,
) -> Tuple[ServingCertificate, List[Diagnostic]]:
    """Certify one pipeline's apply path against a serving envelope.

    ``specs`` are the propagated specs (ingress seeds applied by the
    caller where a boundary is declared; pass the same ``seeds`` here so
    the seeded vertices and everything upstream of them count as the
    request ingress, not as KP901 failures). ``memory`` and ``roofline``
    take the estimates a caller already has, so the pass need not run
    every stage body again; ``record`` appends one ``serving_cert``
    ledger record. Touches no data and no device."""
    envelope = envelope or envelope_from_env() or ServingEnvelope()
    cert = ServingCertificate(envelope=envelope, ingress=ingress)
    diags: List[Diagnostic] = []
    path = apply_path(graph, source, sink)
    shapes = ladder_shapes(envelope, chunk_rows)

    # vertices at or upstream of a declared ingress boundary run at
    # request ingress (decode/extract), outside the certified program
    at_ingress: set = set(seeds or ())
    if at_ingress:
        from ..workflow.analysis import ancestors

        for vid in list(at_ingress):
            at_ingress |= ancestors(graph, vid)
        path = [v for v in path if v not in at_ingress]

    # ---- roofline pricing of the apply path (KP901 + KP903 inputs)
    if roofline is not None:
        est = roofline
    else:
        est, _ = roofline_pass(graph, specs, chunk_rows=chunk_rows)
    per_item = 0.0
    dominating: Tuple[float, Optional[str]] = (0.0, None)
    unpriced: List[Tuple[NodeId, str]] = []
    for vid in path:
        st = est.stages.get(vid)
        if st is not None:
            if st.count:
                item_s = st.predicted_seconds / st.count
                per_item += item_s
                if item_s > dominating[0]:
                    dominating = (item_s, st.label)
            cert.priced_stages += 1
            continue
        op = graph.get_operator(vid)
        out_spec = specs.get(vid)
        if not isinstance(out_spec, DataSpec) or not graph.get_dependencies(vid):
            continue  # estimator outputs / bound data roots: not a stage
        unpriced.append((vid, _label(graph, vid)))
        provable_host = _is_host_stage(graph, vid, specs)
        why = ("host code: the body cannot run on meta tensors, so it "
               "cannot be captured into the chunk loop"
               if provable_host else
               "no propagated element spec reaches this stage")
        fix = ("move the computation into a device body (or "
               "pre-featurize at ingress and certify the device tail)"
               if provable_host else
               "declare a serving-ingress spec for the request boundary "
               "(analysis.serving.SERVING_INGRESS / spec_pass seeds)")
        diags.append(Diagnostic(
            "KP901", Severity.ERROR,
            f"apply-path stage cannot be warmed or scanned — {why}; "
            f"the one-warm-program serving claim fails here. Fix: {fix}",
            vertex=vid, label=_label(graph, vid)))
    cert.unpriced_stages = len(unpriced)
    cert.per_item_seconds = per_item
    cert.dominating_stage = dominating[1]

    # programs an apply: one a priced apply-path stage, an upper bound
    # (fusion and megafusion only lower it)
    cert.programs = max(1, cert.priced_stages)

    # ---- KP902: recompile exposure over the fused plan
    manifest_entries: List[Dict[str, Any]] = []
    exposed: List[str] = []
    try:
        fused = _fused_plan(graph)
        fused_specs, _ = spec_pass_like(graph, fused, specs)
        fpath = set(apply_path(fused, source, sink))
        manifest_entries, covered_inputs = _manifest_entries(
            fused, fused_specs, shapes, path=fpath)
        unpriced_ids = {v for v, _ in unpriced}
        from .hazards import _is_cache_node

        for vid in sorted(fpath, key=lambda n: n.id):
            if vid in covered_inputs or vid in unpriced_ids \
                    or vid in at_ingress:
                continue
            op = fused.get_operator(vid)
            if _is_warm_target(op):
                continue  # a warm target whose input spec is unknown:
                # already carried by the KP901/unpriced accounting
            if _is_cache_node(op) \
                    or getattr(op, "precision_passthrough", False):
                continue  # value-preserving plumbing runs nothing
            out_spec = fused_specs.get(vid)
            if not isinstance(out_spec, DataSpec) \
                    or not fused.get_dependencies(vid):
                continue
            if not is_known(out_spec.element):
                continue  # unpriceable: KP901's finding, not exposure
            exposed.append(op.label)
    except Exception:
        pass  # exposure analysis must never break certification
    cert.manifest = manifest_entries
    cert.exposed_stages = exposed
    if exposed:
        diags.append(Diagnostic(
            "KP902", Severity.WARNING,
            f"recompile exposure: {len(exposed)} apply-path device "
            f"stage(s) outside every warmable fused program "
            f"[{', '.join(sorted(set(exposed))[:4])}] run cold once "
            f"per ladder shape — up to {len(exposed) * len(shapes)} cold "
            f"runs across the envelope's {len(shapes)} shape(s); "
            "declare fusable/fuse() so the warmup manifest covers "
            "them",
            vertex=None, label=label or "<plan>"))
    elif manifest_entries:
        diags.append(Diagnostic(
            "KP902", Severity.INFO,
            f"warm coverage: {len(manifest_entries)} fused program "
            f"site(s) × {len(shapes)} ladder shape(s) "
            f"{shapes} enumerated by warmup_manifest — warmed, every "
            "entry is captured before traffic, so warm serving captures "
            "and builds nothing at any in-envelope shape",
            vertex=None, label=label or "<plan>"))

    # ---- KP903: per-shape certified latency bound vs the SLO
    for n in shapes:
        certified_s, machine_s = shape_bound(per_item, n, cert.programs)
        cert.shapes.append({
            "batch": n,
            "predicted_seconds": certified_s,
            "machine_seconds": machine_s,
        })
    if not unpriced and cert.priced_stages:
        worst = cert.worst_shape
        if worst["predicted_seconds"] > envelope.slo_seconds:
            diags.append(Diagnostic(
                "KP903", Severity.ERROR,
                f"worst in-envelope shape (batch {worst['batch']}) "
                f"predicts ≈{worst['predicted_seconds'] * 1e3:.1f}ms — "
                f"over the {envelope.slo_seconds * 1e3:.0f}ms SLO; "
                f"dominating stage: {cert.dominating_stage} "
                f"(≈{dominating[0] * 1e6:.0f}µs/item). Shrink the "
                "envelope's max_batch, raise the SLO, or optimize the "
                "dominating stage",
                vertex=None, label=label or "<plan>"))
        else:
            diags.append(Diagnostic(
                "KP903", Severity.INFO,
                f"latency bound holds: worst shape (batch "
                f"{worst['batch']}) ≈{worst['predicted_seconds'] * 1e3:.1f}"
                f"ms ≤ {envelope.slo_seconds * 1e3:.0f}ms SLO over "
                f"{len(shapes)} ladder shape(s); dominating stage "
                f"{cert.dominating_stage}; machine bound "
                f"≈{worst['machine_seconds'] * 1e3:.2f}ms",
                vertex=None, label=label or "<plan>"))

    # ---- KP904: an in-place write into the input the caller retains
    for vid in path:
        op = graph.get_operator(vid)
        deps = graph.get_dependencies(vid)
        for i in getattr(op, "donates_deps", ()) or ():
            if i >= len(deps):
                continue  # arity error: KP002's finding
            donated = deps[i]
            if _is_caller_buffer(graph, donated):
                diags.append(Diagnostic(
                    "KP904", Severity.ERROR,
                    f"dependency {i} is the pipeline's own input — a "
                    "serving caller retains the request tensor it "
                    "passed, and this operator writes into it in place, "
                    "so a repeated apply would read overwritten values "
                    "(or force a defensive copy a request); drop the "
                    "in-place write or copy at ingress",
                    vertex=vid, label=_label(graph, vid)))

    # ---- KP905: multi-tenant residency
    if memory is None:
        try:
            from .memory import memory_pass

            memory, _ = memory_pass(graph, specs, chunk_rows=chunk_rows)
        except Exception:
            memory = None
    # one card holds the whole plan: its peak is the per-device peak
    per_dev = (int(memory.peak_bytes) or None) if memory is not None else None
    cert.per_device_peak_bytes = per_dev
    if per_dev:
        budget = hbm_budget_bytes
        if budget is None:
            from ..workflow.env import execution_config

            budget = execution_config().hbm_budget_bytes
        resident = per_dev * envelope.tenants
        if budget and resident > budget:
            diags.append(Diagnostic(
                "KP905", Severity.ERROR,
                f"multi-tenant residency: {envelope.tenants} warmed "
                f"pipeline(s) × {_fmt_bytes(per_dev)} per-device peak = "
                f"{_fmt_bytes(resident)} exceeds the "
                f"{_fmt_bytes(budget)} device memory budget; lower the "
                "tenant "
                "count or the per-pipeline residency",
                vertex=None, label=label or "<plan>"))
        elif envelope.tenants > 1:
            diags.append(Diagnostic(
                "KP905", Severity.INFO,
                f"multi-tenant residency: {envelope.tenants} × "
                f"{_fmt_bytes(per_dev)} = {_fmt_bytes(resident)}"
                + (f" within the {_fmt_bytes(budget)} budget"
                   if budget else " (no device memory budget declared)"),
                vertex=None, label=label or "<plan>"))

    # ---- KP906: unbounded telemetry cardinality on the apply path
    seen_classes: set = set()
    for vid in path:
        cls = type(graph.get_operator(vid))
        if cls in seen_classes:
            continue
        seen_classes.add(cls)
        for method, lineno in _dynamic_metric_sites(cls):
            diags.append(Diagnostic(
                "KP906", Severity.WARNING,
                f"{cls.__qualname__}.{method} (line {lineno}) formats a "
                "telemetry metric name dynamically on the apply path — "
                "per-request names grow the process-wide registry "
                "without bound; use one literal name and carry the "
                "dimension in a span arg",
                vertex=vid, label=_label(graph, vid)))

    cert.certified = not any(d.severity >= Severity.ERROR for d in diags)

    if record:
        _record_certificate(cert, label)
    return cert, diags


def spec_pass_like(raw_graph: Graph, fused: Graph,
                   raw_specs: Dict[GraphId, Any]):
    """Specs for the fused projection of an already propagated graph:
    propagate over the fused graph again, seeding every surviving vertex
    with the raw graph's spec (fusion keeps the vertex ids of chain
    heads, and a seed never overrides a derivable spec), so an ingress
    declaration made on the raw graph carries through."""
    from .propagate import spec_pass

    sources = {
        s: raw_specs[s]
        for s in fused.sources
        if isinstance(raw_specs.get(s), DataSpec)
    }
    seeds = {
        vid: raw_specs[vid]
        for vid in fused.operators
        if isinstance(raw_specs.get(vid), DataSpec)
        and is_known(raw_specs[vid].element)
    }
    return spec_pass(fused, sources, seeds=seeds)


def _is_caller_buffer(graph: Graph, dep: GraphId) -> bool:
    """Is this dependency the pipeline's own input — an unbound source,
    or the data vertex `apply` bound the caller's value into?"""
    from ..workflow.operators import DatasetOperator, DatumOperator

    if isinstance(dep, SourceId):
        return True
    if isinstance(dep, NodeId):
        op = graph.get_operator(dep)
        return isinstance(op, (DatasetOperator, DatumOperator)) \
            and not graph.get_dependencies(dep)
    return False


def _record_certificate(cert: ServingCertificate,
                        label: Optional[str]) -> None:
    """One ``serving_cert`` ledger record a certification: the verdict,
    the priced menu of ladder shapes, and the predicted worst bound."""
    try:
        from ..telemetry.ledger import record_decision

        worst = cert.worst_shape
        record_decision(
            kind="serving_cert",
            rule="ServingCertifier",
            vertices=[],
            labels=[label or "<pipeline>"],
            chosen={"entry": "certified" if cert.certified
                    else "uncertified"},
            alternatives=[
                {"entry": f"batch={s['batch']}",
                 "cost_seconds": s["predicted_seconds"]}
                for s in cert.shapes
            ],
            predicted={
                "worst_shape_seconds": (worst or {}).get(
                    "predicted_seconds", 0.0),
                "slo_seconds": cert.envelope.slo_seconds,
                "ladder_shapes": len(cert.shapes),
                "programs": cert.programs,
            },
            enforced=cert.certified,
        )
    except Exception:
        pass  # a ledger bug must never break certification


def record_runtime_handoff(cert: ServingCertificate,
                           label: Optional[str], *,
                           warmed_sites: int = 0,
                           queue_depth: int = 0,
                           window_ms: float = 0.0,
                           coalesce: bool = True) -> None:
    """One ``serving_handoff`` ledger record a runtime start or swap: the
    moment a static certificate became a live server, with the runtime's
    coalescing knobs and the program sites its warm step warmed, beside
    the certificate's predicted worst bound."""
    try:
        from ..telemetry.ledger import record_decision

        worst = cert.worst_shape
        record_decision(
            kind="serving_handoff",
            rule="ServingRuntime",
            vertices=[],
            labels=[label or "<pipeline>"],
            chosen={
                "entry": ("coalesced micro-batching" if coalesce
                          else "per-request dispatch"),
                "warmed_sites": int(warmed_sites),
                "queue_depth": int(queue_depth),
                "window_ms": float(window_ms),
                "ladder_shapes": [s["batch"] for s in cert.shapes],
            },
            alternatives=[
                {"entry": "per-request dispatch"
                 if coalesce else "coalesced micro-batching",
                 "cost_seconds": 0.0},
            ],
            predicted={
                "worst_shape_seconds": (worst or {}).get(
                    "predicted_seconds", 0.0),
                "slo_seconds": cert.envelope.slo_seconds,
                "per_device_peak_bytes": float(
                    cert.per_device_peak_bytes or 0),
            },
            enforced=cert.certified,
        )
    except Exception:
        pass  # the ledger must never take down a serving start


# ----------------------------------------------------- example certification


def certify_example(name: str, envelope: Optional[ServingEnvelope] = None,
                    *, hbm_budget_bytes: Optional[int] = None,
                    record: bool = False, machine=None, device="cuda"):
    """Certify one registered example end to end: build its
    `analyzable()` graph, seed the declared `SERVING_INGRESS` boundary,
    propagate specs, price memory and run the KP9xx pass. ``machine``
    prices the roofline (default: the calibrated rates); ``device`` holds
    the example's weights. Returns ``(cert, diags)``."""
    from . import as_source_spec
    from .examples import build_example
    from .memory import memory_pass
    from .propagate import spec_pass

    pipeline, source_spec = build_example(name, device=device)
    graph = pipeline.graph
    seeds, decl = ingress_seeds(graph, name)
    specs, _ = spec_pass(
        graph, {pipeline.source: as_source_spec(source_spec)}, seeds=seeds)
    mem, _ = memory_pass(graph, specs)
    roof, _ = roofline_pass(graph, specs, machine=machine)
    return serving_pass(
        graph, specs, envelope, source=pipeline.source, sink=pipeline.sink,
        memory=mem, roofline=roof, hbm_budget_bytes=hbm_budget_bytes,
        label=name, ingress=decl, seeds=seeds, record=record)


# ------------------------------------------------------------- rendering


def format_certificate(cert: ServingCertificate) -> str:
    """Text table of one certificate."""
    lines = [
        f"{'batch':>6} {'certified bound':>16} {'machine bound':>14} "
        f"{'SLO':>10} {'verdict':<8}"
    ]
    slo = cert.envelope.slo_seconds
    for s in cert.shapes:
        ok = "ok" if s["predicted_seconds"] <= slo else "OVER"
        lines.append(
            f"{s['batch']:>6} {s['predicted_seconds'] * 1e3:>13.2f} ms "
            f"{s['machine_seconds'] * 1e3:>11.3f} ms "
            f"{slo * 1e3:>7.0f} ms {ok:<8}")
    if cert.dominating_stage:
        lines.append(f"dominating stage: {cert.dominating_stage} "
                     f"({cert.priced_stages} priced stage(s), "
                     f"≤{cert.programs} program(s)/apply)")
    if cert.ingress:
        lines.append(
            f"ingress: requests enter at {cert.ingress['stage']} as "
            f"{cert.ingress['dtype']}{tuple(cert.ingress['shape'])} — "
            f"{cert.ingress.get('note', '')}")
    if cert.manifest:
        lines.append(
            f"warmup manifest: {len(cert.manifest)} program site(s) × "
            f"{len(cert.shapes)} shapes")
    return "\n".join(lines)
