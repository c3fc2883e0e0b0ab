"""Immutable untyped dataflow graph.

Counterpart of `keystone_tpu/workflow/graph.py:29-382` (reference
workflow/Graph.scala:3-25, workflow/GraphId.scala:1-33). The typed
combinator API (`pipeline.py`) lowers to this untyped DAG of operators.

A `Graph` has three kinds of vertices:
  - **sources**: unbound inputs (bound later when a pipeline is applied),
  - **nodes**: operators with an ordered dependency list,
  - **sinks**: named outputs, each pointing at one node or source.

All mutators are functional: they return a new `Graph`. Graph composition
(`add_graph`, `connect_graph`, `replace_nodes`) is id-remapped surgery
with no compute (Graph.scala:281-434).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Mapping, Optional, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover
    from .operators import Operator


@dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self) -> str:
        return f"Source({self.id})"


@dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self) -> str:
        return f"Node({self.id})"


@dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self) -> str:
        return f"Sink({self.id})"


#: A node dependency may be another node or an unbound source
#: (reference: GraphId.scala `NodeOrSourceId`).
NodeOrSourceId = Union[NodeId, SourceId]

#: Anything executable / addressable in the graph.
GraphId = Union[NodeId, SourceId, SinkId]


class Graph:
    """Immutable DAG. All mutators return a new ``Graph``.

    Mirrors reference Graph.scala:32-457 (fields at :39-43).
    """

    __slots__ = (
        "sources", "sinks", "operators", "dependencies", "sink_dependencies",
        "_users_index", "__weakref__",
    )

    def __init__(
        self,
        sources: Iterable[SourceId] = (),
        sink_dependencies: Mapping[SinkId, NodeOrSourceId] = (),
        operators: Mapping[NodeId, "Operator"] = (),
        dependencies: Mapping[NodeId, Tuple[NodeOrSourceId, ...]] = (),
    ):
        self.sources: frozenset[SourceId] = frozenset(sources)
        self.sink_dependencies: Dict[SinkId, NodeOrSourceId] = dict(sink_dependencies)
        self.operators: Dict[NodeId, "Operator"] = dict(operators)
        self.dependencies: Dict[NodeId, Tuple[NodeOrSourceId, ...]] = {
            k: tuple(v) for k, v in dict(dependencies).items()
        }
        if set(self.operators) != set(self.dependencies):
            raise ValueError("operators and dependencies must have identical node sets")
        self._users_index: Optional[Dict[GraphId, Tuple[GraphId, ...]]] = None

    # ------------------------------------------------------------------ views

    @property
    def nodes(self) -> frozenset[NodeId]:
        return frozenset(self.operators)

    @property
    def sink_ids(self) -> frozenset[SinkId]:
        return frozenset(self.sink_dependencies)

    def get_operator(self, node: NodeId) -> "Operator":
        return self.operators[node]

    def get_dependencies(self, node: NodeId) -> Tuple[NodeOrSourceId, ...]:
        return self.dependencies[node]

    def get_sink_dependency(self, sink: SinkId) -> NodeOrSourceId:
        return self.sink_dependencies[sink]

    # ----------------------------------------------------------- id utilities

    def _next_node_id(self) -> NodeId:
        return NodeId(max((n.id for n in self.operators), default=-1) + 1)

    def _next_source_id(self) -> SourceId:
        return SourceId(max((s.id for s in self.sources), default=-1) + 1)

    def _next_sink_id(self) -> SinkId:
        return SinkId(max((s.id for s in self.sink_dependencies), default=-1) + 1)

    def _check_dep(self, dep: NodeOrSourceId) -> None:
        if isinstance(dep, NodeId):
            if dep not in self.operators:
                raise ValueError(f"dependency {dep} is not in the graph")
        elif isinstance(dep, SourceId):
            if dep not in self.sources:
                raise ValueError(f"dependency {dep} is not in the graph")
        else:
            raise TypeError(f"bad dependency {dep!r}")

    # -------------------------------------------------------------- mutators

    def add_node(
        self, op: "Operator", deps: Iterable[NodeOrSourceId]
    ) -> Tuple["Graph", NodeId]:
        """Add a node for ``op`` depending on ``deps`` (Graph.scala:110-121)."""
        deps = tuple(deps)
        for d in deps:
            self._check_dep(d)
        nid = self._next_node_id()
        ops = dict(self.operators)
        ops[nid] = op
        dd = dict(self.dependencies)
        dd[nid] = deps
        return Graph(self.sources, self.sink_dependencies, ops, dd), nid

    def add_source(self) -> Tuple["Graph", SourceId]:
        sid = self._next_source_id()
        return (
            Graph(self.sources | {sid}, self.sink_dependencies, self.operators, self.dependencies),
            sid,
        )

    def add_sink(self, dep: NodeOrSourceId) -> Tuple["Graph", SinkId]:
        self._check_dep(dep)
        kid = self._next_sink_id()
        sd = dict(self.sink_dependencies)
        sd[kid] = dep
        return Graph(self.sources, sd, self.operators, self.dependencies), kid

    def set_operator(self, node: NodeId, op: "Operator") -> "Graph":
        if node not in self.operators:
            raise ValueError(f"{node} is not in the graph")
        ops = dict(self.operators)
        ops[node] = op
        return Graph(self.sources, self.sink_dependencies, ops, self.dependencies)

    def set_dependencies(self, node: NodeId, deps: Iterable[NodeOrSourceId]) -> "Graph":
        if node not in self.operators:
            raise ValueError(f"{node} is not in the graph")
        deps = tuple(deps)
        for d in deps:
            self._check_dep(d)
        dd = dict(self.dependencies)
        dd[node] = deps
        return Graph(self.sources, self.sink_dependencies, self.operators, dd)

    def set_sink_dependency(self, sink: SinkId, dep: NodeOrSourceId) -> "Graph":
        if sink not in self.sink_dependencies:
            raise ValueError(f"{sink} is not in the graph")
        self._check_dep(dep)
        sd = dict(self.sink_dependencies)
        sd[sink] = dep
        return Graph(self.sources, sd, self.operators, self.dependencies)

    def users_of(self, vid: GraphId) -> Tuple[GraphId, ...]:
        """All direct dependents of ``vid`` — nodes whose dependency list
        contains it plus sinks bound to it — via a lazily built
        reverse-adjacency index. The index costs O(V+E) once per (immutable)
        graph; each query is O(1)."""
        if self._users_index is None:
            idx: Dict[GraphId, list] = {}
            for n, deps in self.dependencies.items():
                for d in dict.fromkeys(deps):  # dedupe repeated deps
                    idx.setdefault(d, []).append(n)
            for s, d in self.sink_dependencies.items():
                idx.setdefault(d, []).append(s)
            self._users_index = {k: tuple(v) for k, v in idx.items()}
        return self._users_index.get(vid, ())

    def _users_of(self, vid: NodeOrSourceId) -> list:
        return list(self.users_of(vid))

    def remove_node(self, node: NodeId) -> "Graph":
        """Remove a node; it must have no users (Graph.scala:170-186)."""
        if node not in self.operators:
            raise ValueError(f"{node} is not in the graph")
        if self._users_of(node):
            raise ValueError(f"cannot remove {node}: it still has dependents")
        ops = dict(self.operators)
        dd = dict(self.dependencies)
        del ops[node], dd[node]
        return Graph(self.sources, self.sink_dependencies, ops, dd)

    def remove_source(self, source: SourceId) -> "Graph":
        if source not in self.sources:
            raise ValueError(f"{source} is not in the graph")
        if self._users_of(source):
            raise ValueError(f"cannot remove {source}: it still has dependents")
        return Graph(
            self.sources - {source}, self.sink_dependencies, self.operators, self.dependencies
        )

    def remove_sink(self, sink: SinkId) -> "Graph":
        if sink not in self.sink_dependencies:
            raise ValueError(f"{sink} is not in the graph")
        sd = dict(self.sink_dependencies)
        del sd[sink]
        return Graph(self.sources, sd, self.operators, self.dependencies)

    def replace_dependency(self, old: NodeOrSourceId, new: NodeOrSourceId) -> "Graph":
        """Rewire every edge pointing at ``old`` to point at ``new``
        (Graph.scala:231-252)."""
        self._check_dep(new)
        dd = {
            n: tuple(new if d == old else d for d in deps)
            for n, deps in self.dependencies.items()
        }
        sd = {s: (new if d == old else d) for s, d in self.sink_dependencies.items()}
        return Graph(self.sources, sd, self.operators, dd)

    # --------------------------------------------------------- graph surgery

    def add_graph(self, other: "Graph") -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Disjoint union with id remapping of ``other``'s vertices
        (Graph.scala:281-325). Returns (graph, other_source_map, other_sink_map).
        """
        node_base = max((n.id for n in self.operators), default=-1) + 1
        source_base = max((s.id for s in self.sources), default=-1) + 1
        sink_base = max((s.id for s in self.sink_dependencies), default=-1) + 1

        node_map = {n: NodeId(node_base + i) for i, n in enumerate(sorted(other.operators))}
        source_map = {s: SourceId(source_base + i) for i, s in enumerate(sorted(other.sources))}
        sink_map = {s: SinkId(sink_base + i) for i, s in enumerate(sorted(other.sink_dependencies))}

        def remap(d: NodeOrSourceId) -> NodeOrSourceId:
            return node_map[d] if isinstance(d, NodeId) else source_map[d]

        ops = dict(self.operators)
        dd = dict(self.dependencies)
        for n, op in other.operators.items():
            ops[node_map[n]] = op
            dd[node_map[n]] = tuple(remap(d) for d in other.dependencies[n])
        sd = dict(self.sink_dependencies)
        for s, d in other.sink_dependencies.items():
            sd[sink_map[s]] = remap(d)
        g = Graph(self.sources | set(source_map.values()), sd, ops, dd)
        return g, source_map, sink_map

    def connect_graph(
        self, other: "Graph", splice: Mapping[SourceId, NodeOrSourceId]
    ) -> Tuple["Graph", Dict[SinkId, SinkId]]:
        """Union with ``other`` then bind each of ``other``'s sources per
        ``splice`` (keys are *other's* source ids; values are vertices of
        ``self``), removing the bound sources (Graph.scala:340-364)."""
        g, source_map, sink_map = self.add_graph(other)
        for other_src, target in splice.items():
            if other_src not in source_map:
                raise ValueError(f"{other_src} is not a source of the spliced graph")
            new_src = source_map[other_src]
            g = g.replace_dependency(new_src, target).remove_source(new_src)
        return g, sink_map

    def replace_nodes(
        self,
        nodes_to_remove: Iterable[NodeId],
        replacement: "Graph",
        replacement_source_splice: Mapping[SourceId, NodeOrSourceId],
        replacement_sink_splice: Mapping[NodeId, SinkId],
    ) -> "Graph":
        """Swap a set of nodes for a replacement sub-graph
        (Graph.scala:379-434).

        ``replacement_source_splice`` binds the replacement's sources to
        surviving vertices of ``self``; ``replacement_sink_splice`` maps each
        removed node to the replacement sink that takes over its users.
        """
        to_remove = set(nodes_to_remove)
        if not to_remove:
            raise ValueError("nodes_to_remove may not be empty")
        for n in to_remove:
            if n not in self.operators:
                raise ValueError(f"{n} is not in the graph")
        if set(replacement_sink_splice) != to_remove:
            raise ValueError("replacement_sink_splice must cover exactly nodes_to_remove")
        # GraphSuite.scala:711-790 argument checks: every replacement
        # source must be bound, every replacement sink attached, and
        # splice targets must be surviving vertices of this graph.
        if set(replacement_source_splice) != set(replacement.sources):
            raise ValueError(
                "replacement_source_splice must cover exactly the "
                "replacement's sources")
        if set(replacement_sink_splice.values()) != set(
            replacement.sink_dependencies
        ):
            raise ValueError(
                "replacement_sink_splice must attach all of the "
                "replacement's sinks")
        for tgt in replacement_source_splice.values():
            if isinstance(tgt, NodeId) and tgt in to_remove:
                raise ValueError("source splice target may not be a removed node")
            if isinstance(tgt, NodeId) and tgt not in self.operators:
                raise ValueError(f"source splice target {tgt} is not in the graph")
            if isinstance(tgt, SourceId) and tgt not in self.sources:
                raise ValueError(f"source splice target {tgt} is not in the graph")

        g, sink_map = self.connect_graph(replacement, replacement_source_splice)
        # Rewire users of each removed node to the replacement sink's dependency.
        for removed, rsink in replacement_sink_splice.items():
            new_sink = sink_map[rsink]
            g = g.replace_dependency(removed, g.get_sink_dependency(new_sink))
        # Drop the replacement's sinks and the removed nodes.
        for rsink in sink_map.values():
            g = g.remove_sink(rsink)
        # Remove in reverse-dependency order (ok since removed nodes may only
        # depend on each other).
        remaining = set(to_remove)
        while remaining:
            progressed = False
            for n in list(remaining):
                if not any(
                    n in g.dependencies[m] for m in remaining if m != n
                ):
                    g = g.remove_node(n)
                    remaining.discard(n)
                    progressed = True
            if not progressed:  # pragma: no cover - cyclic removal set
                raise ValueError("cyclic dependency among removed nodes")
        return g

    # ------------------------------------------------------------------ misc

    def to_dot(self, name: str = "G") -> str:
        """DOT export for plan debugging (Graph.scala:436-455)."""
        lines = [f"digraph {name} {{", "  rankdir=BT;"]
        for s in sorted(self.sources):
            lines.append(f'  source_{s.id} [label="Source {s.id}" shape=box];')
        for n in sorted(self.operators):
            label = getattr(self.operators[n], "label", type(self.operators[n]).__name__)
            lines.append(f'  node_{n.id} [label="{label}"];')
        for k in sorted(self.sink_dependencies):
            lines.append(f'  sink_{k.id} [label="Sink {k.id}" shape=diamond];')

        def vname(v: GraphId) -> str:
            if isinstance(v, SourceId):
                return f"source_{v.id}"
            if isinstance(v, NodeId):
                return f"node_{v.id}"
            return f"sink_{v.id}"

        for n, deps in sorted(self.dependencies.items()):
            for i, d in enumerate(deps):
                lines.append(f'  {vname(d)} -> {vname(n)} [label="{i}"];')
        for k, d in sorted(self.sink_dependencies.items()):
            lines.append(f"  {vname(d)} -> {vname(k)};")
        lines.append("}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (
            f"Graph(sources={sorted(self.sources)}, nodes={sorted(self.operators)}, "
            f"sinks={sorted(self.sink_dependencies)})"
        )
