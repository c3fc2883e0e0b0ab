"""Process-wide pipeline state: the prefix table and the optimizer.

Counterpart of `keystone_tpu/workflow/env.py:504-606` (reference
workflow/{Prefix,PipelineEnv}.scala). A node's `Prefix` is the structural
identity of its ancestry; `PipelineEnv.state` maps the prefixes of
saveable nodes (estimators, `Cacher`s) to the `Expression`s that computed
them, so a later pipeline that holds the same prefix reuses the fit or
the cached dataset instead of recomputing it. The JAX package's
`ExecutionConfig` and its compile cache (`:35-500`) are TPU runtime knobs
with no counterpart here.

The table keeps every saved expression alive, and with it its tensors on
the device: `PipelineEnv.reset()` drops them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .expressions import Expression
from .graph import Graph, NodeId, SourceId


@dataclass(frozen=True)
class Prefix:
    """Structural identity of a node's ancestry (Prefix.scala:4-30)."""

    operator_key: Tuple
    dep_prefixes: Tuple["Prefix", ...]


def compute_prefix(graph: Graph, node: NodeId, _memo=None) -> Optional[Prefix]:
    """Prefix of ``node``, or None if any ancestor is an unbound source
    (unbound ancestry has no stable identity, Prefix.scala:13-27)."""
    if _memo is None:
        _memo = {}
    if node in _memo:
        return _memo[node]
    dep_prefixes = []
    for d in graph.get_dependencies(node):
        if isinstance(d, SourceId):
            _memo[node] = None
            return None
        dp = compute_prefix(graph, d, _memo)
        if dp is None:
            _memo[node] = None
            return None
        dep_prefixes.append(dp)
    p = Prefix(graph.get_operator(node).prefix_key(), tuple(dep_prefixes))
    _memo[node] = p
    return p


class PipelineEnv:
    """Process-wide state: the prefix → Expression table and the current
    optimizer (PipelineEnv.scala:7-45). ``reset()`` drops both."""

    _instance: Optional["PipelineEnv"] = None

    def __init__(self):
        self.state: Dict[Prefix, Expression] = {}
        self._optimizer = None
        #: a node-force profiler (`autocache.NodeProfiler`) while one is
        #: installed, else None
        self.profiler = None

    @classmethod
    def get(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    def get_optimizer(self):
        if self._optimizer is None:
            from .optimizer import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    def set_optimizer(self, optimizer) -> None:
        self._optimizer = optimizer

    @classmethod
    def reset(cls) -> None:
        cls._instance = None


class IdentityKey:
    """Hashable wrapper keying on *object identity* while holding a strong
    reference, so a garbage-collected object's address can never be reused
    by a different object and collide in the prefix table."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, IdentityKey) and other.obj is self.obj

    def __repr__(self) -> str:
        return f"IdentityKey({type(self.obj).__name__}@{id(self.obj):#x})"


def _operator_prefix_key(self) -> Tuple:
    """Default operator identity for prefix and CSE purposes: object
    identity. The reference relies on Scala case-class equality; here an
    operator carrying fitted state or closures is equal only to itself,
    the sharing pattern the reference exploits (the same node object
    reused across pipeline graphs). A `DatasetOperator` is keyed on its
    dataset, a `DatumOperator` on its datum."""
    return (type(self).__qualname__, IdentityKey(self))


# Attach the default prefix_key to Operator without circular imports.
from .operators import DatasetOperator, DatumOperator, Operator  # noqa: E402

Operator.prefix_key = _operator_prefix_key
DatasetOperator.prefix_key = lambda self: ("Dataset", IdentityKey(self.dataset))
DatumOperator.prefix_key = lambda self: ("Datum", IdentityKey(self.datum))
