"""Serial, memoized execution of a pipeline's node chain.

Counterpart of the serial path of `keystone_tpu/workflow/executor.py`
(`GraphExecutor`, reference workflow/GraphExecutor.scala:14-81). A
pipeline here is a chain of nodes; a node that owns a `PrefixMemo`
(`Cacher`) records its output for each (upstream chain, input dataset)
pair. Running a chain starts after the last such node that already holds
the result, so an estimator's fit and a later predict on the same data
share one featurization. The concurrent scheduler, the optimizer and the
planners are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple


class PrefixMemo:
    """Outputs of one caching node, keyed by the identity of the nodes
    upstream of it and of the input dataset. Entries keep their keys
    alive, so an identity can never be reused while it is recorded."""

    def __init__(self):
        self._entries: List[Tuple[tuple, Any, Any]] = []

    def get(self, prefix: tuple, data) -> Any:
        for p, d, value in self._entries:
            if d is data and len(p) == len(prefix) and all(
                    a is b for a, b in zip(p, prefix)):
                return value
        return None

    def put(self, prefix: tuple, data, value) -> None:
        self._entries.append((prefix, data, value))


def execute(nodes: Sequence, data) -> Any:
    """Run ``nodes`` in order on ``data``: a dataset (a `Dataset`, a
    `HostDataset` or a `SparseDataset`, each marked ``is_dataset``) goes
    through each node's batch path, anything else is one datum."""
    nodes = tuple(nodes)
    if not getattr(data, "is_dataset", False):
        for node in nodes:
            data = node.apply(data)
        return data
    start, value = 0, data
    for i in range(len(nodes) - 1, -1, -1):
        memo = getattr(nodes[i], "memo", None)
        hit = memo.get(nodes[:i], data) if memo is not None else None
        if hit is not None:
            start, value = i + 1, hit
            break
    for i in range(start, len(nodes)):
        value = nodes[i].apply_batch(value)
        memo = getattr(nodes[i], "memo", None)
        if memo is not None:
            memo.put(nodes[:i], data, value)
    return value
