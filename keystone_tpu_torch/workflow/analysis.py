"""Graph topology queries.

Counterpart of `keystone_tpu/workflow/analysis.py:10-82` (reference
workflow/AnalysisUtils.scala:15-122).
"""

from __future__ import annotations

from typing import List, Set

from .graph import Graph, GraphId, NodeId, SinkId


def parents(graph: Graph, vid: GraphId) -> List[GraphId]:
    """Direct dependencies of a vertex, in order."""
    if isinstance(vid, SinkId):
        return [graph.get_sink_dependency(vid)]
    if isinstance(vid, NodeId):
        return list(graph.get_dependencies(vid))
    return []


def children(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """Vertices that directly depend on ``vid``.

    Thin wrapper over `Graph.users_of`, whose reverse-adjacency index
    makes each query O(1) after one O(V+E) build."""
    if isinstance(vid, SinkId):
        return set()
    return set(graph.users_of(vid))


def ancestors(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """All transitive dependencies (excluding ``vid``)."""
    seen: Set[GraphId] = set()
    stack = list(parents(graph, vid))
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        stack.extend(parents(graph, v))
    return seen


def descendants(graph: Graph, vid: GraphId) -> Set[GraphId]:
    """All transitive dependents (excluding ``vid``)."""
    seen: Set[GraphId] = set()
    stack = list(children(graph, vid))
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        stack.extend(children(graph, v))
    return seen


def linearize(graph: Graph, vid: GraphId = None) -> List[GraphId]:
    """Deterministic topological order of (the ancestors of) ``vid``, or of
    the whole graph when ``vid`` is None (AnalysisUtils.scala:87-122).

    Dependencies appear before dependents; ties broken by id ordering for
    determinism.
    """
    order: List[GraphId] = []
    visited: Set[GraphId] = set()
    if vid is not None:
        roots: List[GraphId] = [vid]
    else:
        roots = sorted(graph.sink_dependencies, key=lambda s: s.id)
        roots += sorted(graph.operators, key=lambda n: n.id)
    # depth-first post-order with an explicit stack: no recursion limit,
    # and no recursive closure holding the graph in a reference cycle
    for root in roots:
        if root in visited:
            continue
        visited.add(root)
        stack = [(root, iter(parents(graph, root)))]
        while stack:
            v, deps = stack[-1]
            for p in deps:
                if p not in visited:
                    visited.add(p)
                    stack.append((p, iter(parents(graph, p))))
                    break
            else:
                stack.pop()
                order.append(v)
    return order
