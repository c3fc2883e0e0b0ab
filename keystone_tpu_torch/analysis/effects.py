"""Concurrency effect analysis: the race detector of the concurrent
scheduler, and the AST walk the serving certifier's KP906 reads.

Counterpart of `keystone_tpu/analysis/effects.py:1-378` (`Effect`,
`_suppressed`, `_class_defn`, `class_effects`, `operator_effects`,
`interference_pass`, `HOT_METHODS`); pure `ast`, no device.

The scheduler's determinism ("values are pure functions of already
forced dependencies") holds only while operators are pure at apply
time. An operator that writes ``self.*``, a module global or a shared
mutable container in its apply path is *effectful*: two such vertices
with no dependency ordering can be forced at once by the worker pool.

  - **Effect inference** (`class_effects`, `operator_effects`): an AST
    walk over the hot-path method bodies of an operator class (inherited
    methods and the same-class helpers they call included), collecting
    writes to ``self``, to declared globals, and in-place mutations of
    module-level containers. The sanctioned memo idioms are suppressed:
    ``self.__dict__[...]`` memoization and module-level ``*CACHE*``,
    ``*PENDING*``, ``*LOCK*`` and ``*REGISTRY*`` names.
  - **Interference pass** (`interference_pass`, KP511): two effectful
    vertices the scheduler could force at once
    (`workflow.executor.concurrent_relation`) that share mutable state.

Suppress a genuine exception with ``# keystone: ignore[KP511]`` on the
offending line.
"""

from __future__ import annotations

import ast
import inspect
import re
import sys
import textwrap
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, Severity

_IGNORE_RE = re.compile(r"#\s*keystone:\s*ignore\[([A-Z0-9,\s]+)\]")

#: operator methods that run at apply/force time (the hot path the
#: scheduler may execute concurrently). ``__init__``/``fit``/``execute``
#: run during single-threaded wiring or inside one vertex's force and
#: are excluded. ``batch_fn`` is the port's batched body.
HOT_METHODS: Tuple[str, ...] = (
    "apply", "apply_batch", "apply_batch_stream", "single_transform",
    "batch_transform", "batch_transform_stream", "batch_fn", "fuse",
    "_chunk_loop",
)

#: method-call names that mutate their receiver in place.
_MUTATOR_CALLS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear",
})

#: module-level names matching the sanctioned structure-keyed cache
#: idiom (``_PROGRAM_CACHE``, ``_WARMUP_PENDING``, locks...).
_SANCTIONED_GLOBAL = re.compile(r"(CACHE|PENDING|LOCK|REGISTRY)", re.I)


@dataclass(frozen=True)
class Effect:
    """One apply-time write: ``kind`` is ``self_write`` /
    ``global_write`` / ``container_mutation``; ``target`` is
    ``attr:<name>`` for instance state or ``<module>:<name>`` for
    module-level state."""

    kind: str
    target: str
    where: str  # "Class.method:line"

    def __str__(self) -> str:
        return f"{self.kind} {self.target} at {self.where}"

    @property
    def shared_target(self) -> Optional[str]:
        """The process-wide target two DIFFERENT instances could race
        on; instance-local writes return None."""
        return None if self.kind == "self_write" else self.target


# ----------------------------------------------------------- inference


def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    if not (0 < lineno <= len(lines)):
        return False
    m = _IGNORE_RE.search(lines[lineno - 1])
    return bool(m) and rule in {r.strip() for r in m.group(1).split(",")}


def _attr_chain_root(node: ast.AST) -> Optional[ast.AST]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node


def _is_self_dict(node: ast.AST) -> bool:
    """``self.__dict__`` — the sanctioned instance-memo root."""
    return (isinstance(node, ast.Attribute) and node.attr == "__dict__"
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _is_self_dict_chain(node: ast.AST) -> bool:
    """``self.__dict__`` or ``self.__dict__[...]`` — mutator calls on
    either are the sanctioned memo idiom, not shared-state mutation."""
    if _is_self_dict(node):
        return True
    return isinstance(node, ast.Subscript) and _is_self_dict(node.value)


def _first_attr(node: ast.AST) -> str:
    """Attribute name nearest ``self`` in a chain: self.a.b[c] → a."""
    names = []
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            names.append(node.attr)
        node = node.value
    return names[-1] if names else "?"


def _method_effects(
    cls_name: str,
    fn: ast.FunctionDef,
    lines: Sequence[str],
    module_name: str,
    module_globals: Dict[str, Any],
) -> Tuple[List[Effect], Set[str]]:
    """Effects of one method body plus the same-class helper methods it
    calls (``self.helper(...)`` names, resolved by the caller)."""
    effects: List[Effect] = []
    helpers: Set[str] = set()
    declared_globals: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Global):
            declared_globals.update(sub.names)

    def _mutable_module_name(name: Optional[str]) -> bool:
        if name is None or name not in module_globals:
            return False
        if _SANCTIONED_GLOBAL.search(name):
            return False
        return isinstance(module_globals[name], (dict, list, set, bytearray))

    def where(node) -> str:
        return f"{cls_name}.{fn.name}:{node.lineno}"

    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id == "self":
                helpers.add(sub.func.attr)
            # in-place mutation of a module-level OR instance-held
            # container, one attribute/subscript hop allowed
            # (_TABLE["k"].append(...), self.seen.append(...)) — the
            # mutator spelling races exactly like the subscript-assign
            # spelling (self.seen[k] = v) already recorded below
            if sub.func.attr in _MUTATOR_CALLS \
                    and not _is_self_dict_chain(sub.func.value) \
                    and not _suppressed(lines, sub.lineno, "KP511"):
                root = _attr_chain_root(sub.func.value)
                if isinstance(root, ast.Name) \
                        and _mutable_module_name(root.id):
                    effects.append(Effect(
                        "container_mutation",
                        f"{module_name}:{root.id}", where(sub)))
                elif isinstance(root, ast.Name) and root.id == "self" \
                        and isinstance(sub.func.value,
                                       (ast.Attribute, ast.Subscript)):
                    effects.append(Effect(
                        "self_write",
                        f"attr:{_first_attr(sub.func.value)}",
                        where(sub)))

        if not isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            continue
        if _suppressed(lines, sub.lineno, "KP511"):
            continue
        targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
        for t in targets:
            if isinstance(t, ast.Tuple):
                elts: Iterable[ast.AST] = t.elts
            else:
                elts = [t]
            for e in elts:
                if isinstance(e, ast.Name):
                    if e.id in declared_globals:
                        effects.append(Effect(
                            "global_write",
                            f"{module_name}:{e.id}", where(sub)))
                    continue
                root = _attr_chain_root(e)
                if isinstance(root, ast.Name) and root.id == "self":
                    # sanctioned: self.__dict__[...] = ... memoization
                    if isinstance(e, ast.Subscript) \
                            and _is_self_dict(e.value):
                        continue
                    effects.append(Effect(
                        "self_write", f"attr:{_first_attr(e)}", where(sub)))
                elif isinstance(e, (ast.Subscript, ast.Attribute)) \
                        and isinstance(root, ast.Name) \
                        and _mutable_module_name(root.id):
                    effects.append(Effect(
                        "container_mutation",
                        f"{module_name}:{root.id}", where(sub)))
    return effects, helpers


_CLASS_SRC_CACHE: Dict[type, Optional[Tuple[ast.ClassDef, List[str]]]] = {}


def _class_defn(cls: type) -> Optional[Tuple[ast.ClassDef, List[str]]]:
    got = _CLASS_SRC_CACHE.get(cls, False)
    if got is not False:
        return got
    out = None
    try:
        src = textwrap.dedent(inspect.getsource(cls))
        tree = ast.parse(src)
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls.__name__:
                out = (node, src.splitlines())
                break
    except Exception:
        out = None
    _CLASS_SRC_CACHE[cls] = out
    return out


_EFFECT_CACHE: Dict[type, Tuple[Effect, ...]] = {}


def class_effects(cls: type) -> Tuple[Effect, ...]:
    """Apply-time effects of ``cls``: hot-path methods across the MRO
    (each defining class analyzed with its own module namespace), plus
    the same-class helpers those methods call, transitively."""
    got = _EFFECT_CACHE.get(cls)
    if got is not None:
        return got
    effects: List[Effect] = []
    for klass in cls.__mro__:
        if klass.__module__ in ("builtins",):
            continue
        defn = _class_defn(klass)
        if defn is None:
            continue
        node, lines = defn
        methods = {n.name: n for n in node.body
                   if isinstance(n, ast.FunctionDef)}
        module_name = klass.__module__
        mod = sys.modules.get(module_name)
        module_globals = vars(mod) if mod is not None else {}
        pending = [m for m in HOT_METHODS if m in methods]
        seen: Set[str] = set()
        while pending:
            name = pending.pop()
            if name in seen:
                continue
            seen.add(name)
            eff, helpers = _method_effects(
                klass.__name__, methods[name], lines,
                module_name, module_globals)
            effects.extend(eff)
            pending.extend(h for h in helpers
                           if h in methods and h not in seen)
    out = tuple(dict.fromkeys(effects))
    _EFFECT_CACHE[cls] = out
    return out


#: attribute names through which composite operators hold inner stages.
_COMPONENT_ATTRS = ("stages", "branches", "stage_specs")


def _components(op) -> List[Any]:
    """The operator plus every inner stage a composite holds (fused
    chains, gather stages, transformer chains) — a shared inner
    instance is just as racy as a shared outer one."""
    out: List[Any] = []
    seen: Set[int] = set()
    stack = [op]
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        out.append(cur)
        for attr in _COMPONENT_ATTRS:
            val = getattr(cur, attr, None)
            if isinstance(val, (list, tuple)):
                stack.extend(
                    s for s in val if hasattr(s, "__class__")
                    and not isinstance(s, (str, int, float)))
    return out


def operator_effects(op) -> Dict[int, Tuple[Any, Tuple[Effect, ...]]]:
    """Per-component effect map of one operator instance:
    ``id(component) -> (component, effects)``, empty-effect components
    omitted."""
    out: Dict[int, Tuple[Any, Tuple[Effect, ...]]] = {}
    for comp in _components(op):
        eff = class_effects(type(comp))
        if eff:
            out[id(comp)] = (comp, eff)
    return out


# ------------------------------------------------------- interference


def interference_pass(graph) -> List[Diagnostic]:
    """KP511: pairs of effectful vertices the concurrent scheduler could
    force simultaneously while sharing mutable state. Callers gate on
    ``ExecutionConfig.concurrent_dispatch`` — with the scheduler off the
    serial depth-first force totally orders every pair and the race
    cannot occur."""
    from ..workflow.executor import concurrent_relation
    from .propagate import _label

    effectful = []
    for node in sorted(graph.operators, key=lambda n: n.id):
        op = graph.get_operator(node)
        try:
            eff = operator_effects(op)
        except Exception:
            continue  # inference must never break validation
        if eff:
            effectful.append((node, op, eff))
    if len(effectful) < 2:
        return []

    unordered = concurrent_relation(graph)
    diags: List[Diagnostic] = []
    for i in range(len(effectful)):
        for j in range(i + 1, len(effectful)):
            u, op_u, eff_u = effectful[i]
            v, op_v, eff_v = effectful[j]
            if not unordered(u, v):
                continue
            reasons: List[str] = []
            shared_ids = eff_u.keys() & eff_v.keys()
            for sid in sorted(shared_ids):
                comp, eff = eff_u[sid]
                reasons.append(
                    f"both force the same {type(comp).__name__} instance, "
                    f"which mutates itself at apply time ({eff[0]})")
            tgt_u = {e.shared_target for _, effs in eff_u.values()
                     for e in effs if e.shared_target}
            tgt_v = {e.shared_target for _, effs in eff_v.values()
                     for e in effs if e.shared_target}
            for tgt in sorted(tgt_u & tgt_v):
                reasons.append(f"both mutate process-global state {tgt}")
            if not reasons:
                continue
            diags.append(Diagnostic(
                "KP511", Severity.WARNING,
                f"effectful vertices {_label(graph, u)}@{u} and "
                f"{_label(graph, v)}@{v} have no dependency ordering, so "
                "the concurrent DAG scheduler may force them "
                f"simultaneously: {'; '.join(reasons)}. Order them "
                "explicitly, make the state per-instance (or memoize via "
                "self.__dict__), or revert to the serial force "
                "(KEYSTONE_CONCURRENT_DISPATCH=0)",
                vertex=v, label=_label(graph, v)))
    return diags
