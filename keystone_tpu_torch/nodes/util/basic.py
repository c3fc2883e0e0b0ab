"""Small utility nodes.

Counterpart of `ClassLabelIndicatorsFromInt`, `MaxClassifier` and
`Cacher` in `keystone_tpu/nodes/util/basic.py` (reference
nodes/util/{ClassLabelIndicators,MaxClassifier,Cacher}.scala).
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


class Cacher(Transformer):
    """Keep the dataset that reaches this node, for every (upstream
    chain, input) pair, so a later run of the same chain on the same
    input starts here (Cacher.scala:15-25)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.memo = PrefixMemo()

    def batch_fn(self):
        return lambda x: x
