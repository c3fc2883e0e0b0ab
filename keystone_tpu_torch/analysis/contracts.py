"""Registry-wide static operator contract auditor (the KP5xx family).

Counterpart of `keystone_tpu/analysis/contracts.py:1-750`. The fusion,
megafusion and scheduling machinery rests on contracts operators
declare (``fusable`` and ``fuse()``, ``chunkable``, ``fusable_fit``,
``donates_deps``, ``fuse_masks_output``); this module checks them:

  KP501  fusable-without-structural-fuse: a stage declaring ``fusable``
         (or promised through an estimator's ``fusable_fit``) whose key,
         from the same `nodes/util/fusion.py::stage_fuse` the fusion
         builder uses, holds an id-keyed ``("opaque", id)`` entry. A
         fused chain that holds one is keyed ``("FusedChain", ...,
         ("opaque", id), ...)``: its launch plans and graphs are the
         instance's, and a rebuilt pipeline builds them again.
  KP502  chunkable-non-distributive: ``chunkable = True`` whose batch
         path provably does not distribute over chunks: the stage's
         batch function run on meta tensors (`specs.trace_element`, no
         data moves) at 3, 4 and 7 rows must give outputs whose leading
         axes add up and whose tails agree.
  KP503  donation-not-implemented: ``donates_deps`` declared. JAX
         checks for a jitted step with ``donate_argnums``; torch has no
         such mechanism and the port recognizes none, so any declared
         donation fires. No operator of either package declares one
         (the default ``()``, `keystone_tpu/workflow/operators.py:121`).
  KP504  unmasked-fused-stage: a ``fusable`` stage whose unfused batch
         path reads the dataset's ``mask`` but does not declare
         ``fuse_masks_output``.

Two surfaces: ``contract_pass(graph, specs)`` over the operators of one
lowered graph, run by ``validate(level="full")``, and
``audit_registry()`` (``python -m keystone_tpu_torch.analysis
--audit-operators``) over every `Operator` subclass the port defines,
with probe instances where construction is known (`_probe_factories`,
the port's classes of JAX's table at `:127-207`) and the class-level
checks otherwise. A genuine exception is suppressed with a
``# keystone: ignore[KP50x]`` comment on (or just above) the ``class``
line.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
import re
import sys
import textwrap
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .diagnostics import Diagnostic, Severity
from .specs import (
    DataSpec,
    SpecMismatchError,
    is_known,
    shape_struct,
    trace_element,
)

_IGNORE_RE = re.compile(r"#\s*keystone:\s*ignore\[([A-Z0-9,\s]+)\]")

#: modules swept for Operator subclasses: importing them registers every
#: built-in node class through ``__subclasses__``
_REGISTRY_ROOTS = (
    "keystone_tpu_torch.nodes",
    "keystone_tpu_torch.workflow.pipeline",
    "keystone_tpu_torch.workflow.operators",
    "keystone_tpu_torch.workflow.fusion_rule",
)

_PACKAGE = "keystone_tpu_torch."


# ---------------------------------------------------------------- registry


def _import_registry() -> None:
    for root in _REGISTRY_ROOTS:
        mod = importlib.import_module(root)
        if hasattr(mod, "__path__"):
            for info in pkgutil.walk_packages(mod.__path__, root + "."):
                try:
                    importlib.import_module(info.name)
                except Exception:
                    pass  # an optional-dep module must not kill the sweep


def _all_subclasses(cls: type) -> Iterable[type]:
    for sub in cls.__subclasses__():
        yield sub
        yield from _all_subclasses(sub)


def operator_registry() -> List[type]:
    """Every `Operator` subclass defined in the port, in a fixed order."""
    from ..workflow.operators import Operator

    _import_registry()
    seen: Dict[type, None] = {}
    for cls in _all_subclasses(Operator):
        if cls.__module__.startswith(_PACKAGE):
            seen.setdefault(cls)
    return sorted(seen, key=lambda c: (c.__module__, c.__qualname__))


# ------------------------------------------------------------------ probes


def _cls(module: str, name: str) -> type:
    return getattr(importlib.import_module(_PACKAGE + module), name)


def _probe_factories() -> Dict[str, Any]:
    """class name -> zero-argument factory of ``(instance, element
    shapes)``, so that classes whose constructors need arguments still
    get the instance-level checks. Parameters live on the CPU: the
    checks run the bodies on meta tensors."""

    def conv():
        return _cls("nodes.images.core", "Convolver")(
            np.ones((2, 3, 3, 3), np.float32), 8, 8, 3, device="cpu"), \
            [(8, 8, 3)]

    def conv_rect_pool():
        c = _cls("nodes.images.core", "Convolver")(
            np.ones((2, 3, 3, 3), np.float32), 8, 8, 3, device="cpu")
        return _cls("nodes.util.fusion", "_ConvRectifyPoolStage")(
            c, 0.0, 0.0, 2, 2), [(8, 8, 3)]

    def hellinger():
        return _cls("nodes.stats.normalization", "SignedHellingerMapper")()

    def fused_chain(cls_name):
        return lambda: (_cls("nodes.util.fusion", cls_name)([hellinger()]),
                        [(6,)])

    ones = torch.ones((6, 3))
    return {
        "Convolver": conv,
        "_ConvRectifyPoolStage": conv_rect_pool,
        "_RectifyPoolStage": lambda: (
            _cls("nodes.util.fusion", "_RectifyPoolStage")(0.0, 0.0, 2, 2),
            [(8, 8, 2)]),
        "Pooler": lambda: (_cls("nodes.images.core", "Pooler")(2, 2),
                           [(8, 8, 3)]),
        "Cropper": lambda: (
            _cls("nodes.images.core", "Cropper")(0, 0, 4, 4), [(8, 8, 3)]),
        "ClassLabelIndicatorsFromInt": lambda: (
            _cls("nodes.util.basic", "ClassLabelIndicatorsFromInt")(4),
            [()]),
        "ClassLabelIndicatorsFromIntArray": lambda: (
            _cls("nodes.util.basic", "ClassLabelIndicatorsFromIntArray")(4),
            [(3,)]),
        "ColumnSampler": lambda: (
            _cls("nodes.stats.normalization", "ColumnSampler")(4),
            [(8, 6)]),
        "CosineRandomFeatures": lambda: (
            _cls("nodes.stats.random_features", "CosineRandomFeatures")(
                6, 8, device="cpu"), [(6,)]),
        "RandomSignNode": lambda: (
            _cls("nodes.stats.random_features", "RandomSignNode")(
                6, device="cpu"), [(6,)]),
        "StandardScalerModel": lambda: (
            _cls("nodes.stats.scalers", "StandardScalerModel")(
                torch.zeros(6), torch.ones(6)), [(6,)]),
        "LinearMapper": lambda: (
            _cls("nodes.learning.linear", "LinearMapper")(ones), [(6,)]),
        "BlockLinearMapper": lambda: (
            _cls("nodes.learning.block_ls", "BlockLinearMapper")(ones),
            [(6,)]),
        "BlockLeastSquaresEstimator": lambda: (
            _cls("nodes.learning.block_ls", "BlockLeastSquaresEstimator")(
                4, 1), [(6,)]),
        "MatrixVectorizer": lambda: (
            _cls("nodes.util.basic", "MatrixVectorizer")(), [(4, 3)]),
        "_FunctionTransformer": lambda: (
            _cls("workflow.pipeline", "_FunctionTransformer")(lambda x: x),
            [(6,)]),
        "TransformerChain": lambda: (
            _cls("workflow.pipeline", "TransformerChain")([hellinger()]),
            [(6,)]),
        "FusedBatchTransformer": fused_chain("FusedBatchTransformer"),
        "MegafusedBatchTransformer": fused_chain("MegafusedBatchTransformer"),
        "_GatherConcatStage": lambda: (
            _cls("nodes.util.fusion", "_GatherConcatStage")([hellinger()]),
            [(6,)]),
    }


#: element shapes tried when a probe declares none
_DEFAULT_ELEMS: Tuple[Tuple[int, ...], ...] = ((6,), (8, 8, 3))


def probe_instance(cls: type):
    """``(instance, element shapes)`` of ``cls`` for the instance-level
    checks, or ``(None, ())`` where it cannot be built without real
    state."""
    factory = _probe_factories().get(cls.__name__)
    if factory is not None:
        try:
            return factory()
        except Exception:
            return None, ()
    try:
        return cls(), list(_DEFAULT_ELEMS)
    except Exception:
        return None, ()


# --------------------------------------------------------- AST utilities


def _class_ast(cls: type) -> Optional[ast.ClassDef]:
    """The class's own ``ClassDef`` (None without source, e.g. a class
    built with ``type(...)``)."""
    try:
        src = textwrap.dedent(inspect.getsource(cls))
    except Exception:
        return None
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls.__name__:
            return node
    return None


def suppressed_rules(cls: type) -> frozenset:
    """Rules suppressed with ``# keystone: ignore[KP50x]`` on (or right
    above) the ``class`` line."""
    try:
        lines, _ = inspect.getsourcelines(cls)
    except Exception:
        return frozenset()
    head = []
    for line in lines:
        head.append(line)
        if line.lstrip().startswith("class ") and line.rstrip().endswith(":"):
            break
        if len(head) > 8:
            break
    out = set()
    for line in head:
        m = _IGNORE_RE.search(line)
        if m:
            out.update(r.strip() for r in m.group(1).split(","))
    return frozenset(out)


def _batch_methods(cls_node: ast.ClassDef) -> List[ast.FunctionDef]:
    return [n for n in cls_node.body
            if isinstance(n, ast.FunctionDef)
            and n.name in ("apply_batch", "batch_transform")]


def _reads_mask(cls: type) -> bool:
    """Does the class's unfused batch path read a dataset's ``.mask``?
    Walks the MRO: an inherited masking batch path inherits the
    contract."""
    for klass in cls.__mro__:
        node = _class_ast(klass)
        if node is None:
            continue
        for fn in _batch_methods(node):
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Attribute) and sub.attr == "mask" \
                        and isinstance(sub.ctx, ast.Load):
                    return True
    return False


# ----------------------------------------------------------- rule checks


def _static_attr(cls: type, name: str):
    """A class attribute without running properties: the descriptor of a
    property-valued contract, the plain value otherwise."""
    try:
        return inspect.getattr_static(cls, name)
    except AttributeError:
        return None


def _defines_fuse(cls: type) -> bool:
    return callable(getattr(cls, "fuse", None))


def _contains_opaque(key) -> bool:
    """Whether a (possibly nested) static key holds an id-keyed
    ``"opaque"`` entry (`fusion.py:265-271`)."""
    if isinstance(key, tuple):
        return any(_contains_opaque(k) for k in key)
    return key == "opaque"


def _batch_function(op):
    """The stage's whole-batch function: its ``batch_fn()``, else its
    per-item ``apply`` over the rows (JAX's ``vmap(stage.apply)``)."""
    try:
        return op.batch_fn()
    except NotImplementedError:
        return lambda xb: torch.stack([op.apply(x) for x in xb])


def _decompose(op) -> Tuple[Optional[Any], Any, Any, Optional[str]]:
    """The stage's fused decomposition as the fusion builder takes it
    (`stage_fuse`) with its batch function: ``(key, params, fn, None)``,
    or ``(None, None, None, reason)`` where it fails. Shared by KP501
    (the key) and KP502 (the function)."""
    from ..nodes.util.fusion import stage_fuse

    try:
        key, params = stage_fuse(op)
        return key, params, _batch_function(op), None
    except Exception as e:
        return None, None, None, f"{type(e).__name__}: {e}"


def _kp501_instance(op, label: str, decomp=None,
                    vertex=None) -> List[Diagnostic]:
    if not getattr(op, "fusable", False):
        return []
    key, _, _, err = decomp if decomp is not None else _decompose(op)
    if err is not None:
        return [Diagnostic(
            "KP501", Severity.WARNING,
            f"fusable stage's fuse() decomposition failed ({err}); fused "
            "programs containing it cannot build",
            vertex=vertex, label=label)]
    if _contains_opaque(key):
        how = ("declares fusable but implements no fuse() decomposition"
               if not _defines_fuse(type(op))
               else "fuse() returns an id-keyed (opaque) component")
        return [Diagnostic(
            "KP501", Severity.WARNING,
            f"{how}: fused chains holding this stage keep their launch "
            "plans and graphs per instance and build them again on every "
            "rebuilt pipeline; implement a structural fuse() keyed by "
            "structure with the parameters beside the key",
            vertex=vertex, label=label)]
    return []


def _kp502_instance(op, label: str, elems: Sequence[Any], decomp=None,
                    vertex=None) -> List[Diagnostic]:
    """The declared-chunkable batch path's distributivity, shown or
    refuted on meta tensors: the whole-batch form against two chunk
    forms."""
    if not getattr(op, "chunkable", False):
        return []
    _, _, fn, err = decomp if decomp is not None else _decompose(op)
    if err is not None:
        return []  # the decomposition's failure is KP501's finding

    for elem in elems:
        if not (hasattr(elem, "shape") and hasattr(elem, "dtype")):
            elem = shape_struct(tuple(elem), np.float32)
        shapes = {}
        failed = False
        for n in (3, 4, 7):
            xs = shape_struct((n,) + tuple(elem.shape), elem.dtype)
            try:
                out = trace_element(fn, (xs,))
            except SpecMismatchError:
                # a shape complaint against a probe's element means the
                # probe guessed the input shape wrong: try the next one
                failed = True
                break
            if not is_known(out) or not (
                    hasattr(out, "shape") and hasattr(out, "dtype")):
                failed = True  # host code or a tuple out: not provable
                break
            shapes[n] = (tuple(out.shape), out.dtype)
        if failed:
            continue
        (s3, d3), (s4, d4), (s7, d7) = shapes[3], shapes[4], shapes[7]
        ok = (
            len(s3) == len(s4) == len(s7)
            and len(s3) >= 1
            and s3[1:] == s4[1:] == s7[1:]
            and d3 == d4 == d7
            and s3[0] + s4[0] == s7[0]
        )
        if not ok:
            return [Diagnostic(
                "KP502", Severity.ERROR,
                "declares chunkable but the batch path provably does not "
                f"distribute over chunks: on meta tensors it gives {s3}+{s4} "
                f"for chunks of 3+4 rows vs {s7} for the whole 7-row batch "
                "(f(concat(chunks)) != concat(f(chunks))); drop the "
                "chunkable declaration or make the batch path map-like "
                "in the example axis",
                vertex=vertex, label=label)]
        return []  # shown distributive on the first traceable element
    return []


def _kp503_class(cls: type) -> List[Diagnostic]:
    donates = _static_attr(cls, "donates_deps")
    if not isinstance(donates, tuple) or not donates:
        return []
    return [Diagnostic(
        "KP503", Severity.WARNING,
        f"declares donates_deps={donates!r}, but torch has no "
        "donate_argnums and the port recognizes no donation mechanism: "
        "the dependency's tensor is never donated (and KP301 restricts "
        "the producer's consumers for nothing)",
        label=cls.__name__)]


def _kp504_class(cls: type) -> List[Diagnostic]:
    if not isinstance(_static_attr(cls, "fusable"), bool) \
            or not cls.fusable:
        # property-valued fusable classes are checked per instance
        if not isinstance(getattr(cls, "fusable", False), property):
            return []
    if bool(_static_attr(cls, "fuse_masks_output")):
        return []
    if not _reads_mask(cls):
        return []
    return [Diagnostic(
        "KP504", Severity.ERROR,
        "the unfused batch path masks padded rows (reads the dataset "
        "mask) but the class declares no fuse_masks_output — inside a "
        "fused chain padded rows would stop being re-zeroed and "
        "mask-less reductions downstream would read corrupt values",
        label=cls.__name__)]


def _mask_aware_fuse(op) -> bool:
    """The fusion machinery's own classes (`FusedBatchTransformer` and
    its megafused form, `_GatherConcatStage`) run their stages over the
    rows they are given, so KP504 does not apply to them (JAX tells them
    apart by a mask-aware sentinel in ``fuse()``, `:566-580`)."""
    from ..nodes.util.fusion import FusedBatchTransformer, _GatherConcatStage

    return isinstance(op, (FusedBatchTransformer, _GatherConcatStage))


def _fit_return_classes(cls: type) -> List[type]:
    """Classes constructed in ``fit``/``fit_datasets`` return statements,
    resolved in the defining module: the static answer to "what
    transformer does this estimator produce?"."""
    node = _class_ast(cls)
    if node is None:
        return []
    mod = sys.modules.get(cls.__module__)
    ns = vars(mod) if mod is not None else {}
    out: List[type] = []
    for fn in node.body:
        if not isinstance(fn, ast.FunctionDef) \
                or fn.name not in ("fit", "fit_datasets"):
            continue
        for sub in ast.walk(fn):
            if not (isinstance(sub, ast.Return)
                    and isinstance(sub.value, ast.Call)):
                continue
            f = sub.value.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            got = ns.get(name)
            if isinstance(got, type):
                out.append(got)
    return out


def _kp501_estimator_class(cls: type) -> List[Diagnostic]:
    """``fusable_fit`` promises a fit that yields a fusable transformer;
    the fitted class must then carry a structural fuse()."""
    from ..workflow.operators import Operator

    if not bool(_static_attr(cls, "fusable_fit")):
        return []
    diags: List[Diagnostic] = []
    for fitted in _fit_return_classes(cls):
        if not (isinstance(fitted, type) and issubclass(fitted, Operator)):
            continue
        fus = _static_attr(fitted, "fusable")
        declared = (isinstance(fus, property)
                    or (isinstance(fus, bool) and fus))
        if declared and not _defines_fuse(fitted):
            diags.append(Diagnostic(
                "KP501", Severity.WARNING,
                f"fusable_fit promises a fusable fit, but the fitted "
                f"class {fitted.__name__} declares fusable without a "
                "structural fuse() — fused chains crossing this "
                "estimator boundary are keyed per instance and build "
                "their launch plans again on every re-apply",
                label=cls.__name__))
    return diags


def _kp501_instance_classlevel(cls: type) -> List[Diagnostic]:
    return [Diagnostic(
        "KP501", Severity.WARNING,
        "declares fusable but implements no fuse() decomposition: fused "
        "chains holding this stage are keyed per instance and build "
        "their launch plans and graphs again on every rebuilt pipeline",
        label=cls.__name__)]


# ------------------------------------------------------------- audit API


def audit_operator(op, elems: Sequence[Any] = (),
                   vertex=None) -> List[Diagnostic]:
    """The instance-level audit of one operator (`:640-661`): KP501 on
    its key, KP502 over ``elems``, and the class-level KP503/KP504
    checks, less the rules its class line suppresses."""
    cls = type(op)
    label = getattr(op, "label", cls.__name__)
    decomp = _decompose(op)
    diags: List[Diagnostic] = []
    diags.extend(_kp501_instance(op, label, decomp, vertex=vertex))
    if elems:
        diags.extend(_kp502_instance(op, label, elems, decomp,
                                     vertex=vertex))
    kp504 = _kp504_class(cls)
    if kp504 and _mask_aware_fuse(op):
        kp504 = []
    for d in _kp503_class(cls) + kp504 + _kp501_estimator_class(cls):
        diags.append(Diagnostic(d.rule, d.severity, d.message,
                                vertex=vertex, label=label))
    sup = suppressed_rules(cls)
    return [d for d in diags if d.rule not in sup]


def audit_class(cls: type) -> Tuple[List[Diagnostic], bool]:
    """The registry's audit of one operator class (`:664-685`):
    ``(diagnostics, probed)``; ``probed`` False means only the class
    checks could run."""
    op, elems = probe_instance(cls)
    diags: List[Diagnostic] = []
    if op is not None:
        decomp = _decompose(op)
        diags.extend(_kp501_instance(op, cls.__name__, decomp))
        diags.extend(_kp502_instance(op, cls.__name__, elems, decomp))
    else:
        fus = _static_attr(cls, "fusable")
        if isinstance(fus, bool) and fus and not _defines_fuse(cls):
            diags.extend(_kp501_instance_classlevel(cls))
    diags.extend(_kp503_class(cls))
    kp504 = _kp504_class(cls)
    if kp504 and op is not None and _mask_aware_fuse(op):
        kp504 = []
    diags.extend(kp504)
    diags.extend(_kp501_estimator_class(cls))
    sup = suppressed_rules(cls)
    return [d for d in diags if d.rule not in sup], op is not None


def audit_registry() -> Tuple[List[Tuple[type, Diagnostic]], Dict[str, int]]:
    """Every operator class of the port audited: the findings by class
    and the sweep's counts."""
    findings: List[Tuple[type, Diagnostic]] = []
    probed = 0
    classes = operator_registry()
    for cls in classes:
        diags, was_probed = audit_class(cls)
        probed += bool(was_probed)
        findings.extend((cls, d) for d in diags)
    return findings, {"classes": len(classes), "probed": probed}


# ------------------------------------------------------------ graph pass


def _input_elems(graph, node, specs) -> List[Any]:
    """The known element spec feeding ``node``: KP502 runs at the
    pipeline's propagated shapes where there are some."""
    elems = []
    for d in graph.get_dependencies(node):
        s = specs.get(d)
        if isinstance(s, DataSpec) and is_known(s.element) \
                and hasattr(s.element, "shape"):
            elems.append(s.element)
    return elems[:1]


def contract_pass(graph, specs: Optional[Dict] = None) -> List[Diagnostic]:
    """KP5xx over every operator of a lowered graph, at its propagated
    input specs (the ``validate(level="full")`` tier, `:726-750`); one
    finding per (rule, anchor, message)."""
    specs = specs or {}
    diags: List[Diagnostic] = []
    for node in sorted(graph.operators, key=lambda n: n.id):
        op = graph.get_operator(node)
        try:
            diags.extend(audit_operator(
                op, _input_elems(graph, node, specs), vertex=node))
        except Exception:
            continue  # the audit never breaks validation
    seen = set()
    out = []
    for d in diags:
        k = (d.rule, d.anchor, d.message)
        if k not in seen:
            seen.add(k)
            out.append(d)
    return out
