"""VectorSplitter: the feature axis cut into blocks.

Counterpart of `keystone_tpu/nodes/util/vector_splitter.py` (`:10-37`;
reference nodes/util/VectorSplitter.scala:10-36). The block solvers
slice the feature axis themselves (`block_ls.py`); this node gives the
blocks to a caller: views of the rows, each a `Dataset` with the
source's count.
"""

from __future__ import annotations

from typing import List, Optional

from ...data.dataset import Dataset
from ...workflow.pipeline import Transformer


class VectorSplitter(Transformer):
    def __init__(self, block_size: int, num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_features = num_features

    def apply(self, x):
        d = self.num_features or x.shape[-1]
        return [x[..., start:min(start + self.block_size, d)]
                for start in range(0, d, self.block_size)]

    def apply_batch(self, data: Dataset) -> List[Dataset]:
        X = data.array
        d = self.num_features or X.shape[1]
        return [data.with_data(X[:, start:min(start + self.block_size, d)])
                for start in range(0, d, self.block_size)]
