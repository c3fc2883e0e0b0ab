"""Small utility nodes.

Counterpart of `ClassLabelIndicatorsFromInt`, `MaxClassifier`,
`VectorCombiner` (`:165-182`) and `Cacher` in
`keystone_tpu/nodes/util/basic.py` (reference
nodes/util/{ClassLabelIndicators,MaxClassifier,VectorCombiner,
Cacher}.scala).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...workflow.executor import PrefixMemo
from ...workflow.pipeline import Transformer


class ClassLabelIndicatorsFromInt(Transformer):
    """int label → length-k float32 vector of −1/+1."""

    def __init__(self, num_classes: int):
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes

    def batch_fn(self):
        return lambda y: (2.0 * F.one_hot(y.long(), self.num_classes)
                          - 1.0).to(torch.float32)


class MaxClassifier(Transformer):
    """argmax over scores → int label (MaxClassifier.scala)."""

    def batch_fn(self):
        return lambda x: torch.argmax(x, dim=-1)


class VectorCombiner(Transformer):
    """Concatenate the tuple of branch outputs that gather produces along
    the last axis (VectorCombiner.scala)."""

    def apply(self, xs):
        return torch.cat([torch.as_tensor(x) for x in xs], dim=-1)

    def apply_batch(self, data):
        # one output, allocated once, each branch copied into its columns
        return data.with_data(torch.cat(data.data, dim=-1))


class Cacher(Transformer):
    """Keep the dataset that reaches this node, for every (upstream
    chain, input) pair, so a later run of the same chain on the same
    input starts here (Cacher.scala:15-25)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.memo = PrefixMemo()

    def batch_fn(self):
        return lambda x: x
