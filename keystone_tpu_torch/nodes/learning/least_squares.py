"""Least-squares solver choice by cost model.

Counterpart of `keystone_tpu/nodes/learning/least_squares.py`
(`:26-166`; reference nodes/learning/LeastSquaresEstimator.scala:26-86):
an `OptimizableLabelEstimator` whose `optimize` measures (n, d, k,
sparsity, devices) from a sample and takes the cheapest of four
candidates by `cost_model`: dense L-BFGS, sparse L-BFGS (only below
density 0.1), BCD (block 4096, three sweeps) and the exact normal
equations, each dense solver behind `Densify` so sparse input survives
the route (:59-84). ``num_chips=None`` prices the data's mesh shards
(the current mesh's where the sample has none; one card without a
group), as JAX's `:92` reads them.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ...data.dataset import Dataset
from ...data.sparse import SparseDataset
from ...parallel.mesh import n_data_shards
from ...workflow.pipeline import (
    LabelEstimator,
    LabelEstimatorChain,
    OptimizableLabelEstimator,
)
from ..util.basic import Densify
from .block_ls import BlockLeastSquaresEstimator
from .cost_model import (
    BlockSolverCostModel,
    CostModel,
    CostProfile,
    ExactSolverCostModel,
    LBFGSCostModel,
)
from .lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
from .linear import LinearMapEstimator

logger = logging.getLogger(__name__)

#: rows of a dense sample whose nonzeros give its density (JAX's
#: `spread_take(256)`: evenly spread rows, not a head prefix)
DENSITY_SAMPLE_ROWS = 256


class LeastSquaresEstimator(OptimizableLabelEstimator):
    """The cheapest least-squares solver for the measured workload
    (LeastSquaresEstimator.scala:26-86). Weights not given are the
    resolved ones (`cost_model`). After `optimize`, ``chosen`` names
    the candidate and ``costs`` holds each candidate's estimate."""

    precision_tolerance = "exact"  # whichever solver wins, it pins f32

    mesh_aware = True  # its fit is the chosen solver's, which is guarded

    def __init__(self, lam: float = 0.0, num_iters: int = 20,
                 block_size: int = 4096, num_chips: Optional[int] = None,
                 cpu_weight: Optional[float] = None,
                 mem_weight: Optional[float] = None,
                 network_weight: Optional[float] = None):
        self.lam = lam
        self.num_iters = num_iters
        self.block_size = block_size
        self.num_chips = num_chips
        self.cpu_weight, self.mem_weight, self.network_weight = (
            CostModel._weights(cpu_weight, mem_weight, network_weight))
        self.chosen: Optional[str] = None
        self.costs: dict = {}

    def abstract_fit(self, in_specs):
        """Whichever solver the cost model picks, the model maps (d,)
        features to (k,) scores."""
        from ...analysis.specs import supervised_fit_spec

        return supervised_fit_spec(in_specs, self.label)

    @classmethod
    def calibrated(cls, lam: float = 0.0, probe_kwargs: Optional[dict] = None,
                   **kwargs) -> "LeastSquaresEstimator":
        """With weights measured on the device (`calibrate`) instead of
        the resolved ones; ``probe_kwargs`` go to
        `calibrate_cost_weights` (the device, smaller probes)."""
        from .calibrate import calibrate_cost_weights

        w = calibrate_cost_weights(**(probe_kwargs or {}))
        return cls(lam=lam, cpu_weight=w.cpu_weight,
                   mem_weight=w.mem_weight,
                   network_weight=w.network_weight, **kwargs)

    @property
    def default(self) -> LabelEstimator:
        return DenseLBFGSwithL2(self.lam, num_iters=self.num_iters)

    def _measure(self, sample, sample_labels, num_per_shard) -> CostProfile:
        chips = self.num_chips or n_data_shards(getattr(sample, "mesh",
                                                        None))
        n = num_per_shard * chips
        if isinstance(sample, SparseDataset):
            d, sparsity = sample.dim, sample.sparsity
        else:
            if isinstance(sample, Dataset):
                d = sample.array.shape[1]
                arr = sample.sample_per_shard(DENSITY_SAMPLE_ROWS).numpy()
            else:
                arr = np.asarray(sample.items if hasattr(sample, "items")
                                 else sample)
                d = arr.shape[1]
            sparsity = float(np.count_nonzero(arr)) / max(arr.size, 1)
        if isinstance(sample_labels, Dataset):
            k = sample_labels.array.shape[1]
        else:
            k = np.asarray(sample_labels.items[0]).shape[-1]
        return CostProfile(n=n, d=d, k=k, sparsity=sparsity, num_chips=chips)

    def optimize(self, sample, sample_labels,
                 num_per_shard: int) -> LabelEstimator:
        p = self._measure(sample, sample_labels, num_per_shard)
        w = (self.cpu_weight, self.mem_weight, self.network_weight)

        def densified(est: LabelEstimator) -> LabelEstimator:
            return LabelEstimatorChain(Densify(), est)

        candidates = [
            (LBFGSCostModel(self.num_iters, sparse=False).cost(p, *w),
             lambda: densified(DenseLBFGSwithL2(self.lam,
                                                num_iters=self.num_iters)),
             "dense-lbfgs"),
            (LBFGSCostModel(self.num_iters, sparse=True).cost(p, *w)
             if p.sparsity < 0.1 else float("inf"),
             lambda: SparseLBFGSwithL2(self.lam, num_iters=self.num_iters),
             "sparse-lbfgs"),
            (BlockSolverCostModel(self.block_size, num_iter=3).cost(p, *w),
             lambda: densified(BlockLeastSquaresEstimator(
                 self.block_size, 3, self.lam)),
             "block-ls"),
            (ExactSolverCostModel().cost(p, *w),
             lambda: densified(LinearMapEstimator(self.lam)),
             "exact"),
        ]
        cost, make, name = min(candidates, key=lambda c: c[0])
        logger.info("LeastSquaresEstimator: n=%d d=%d k=%d sparsity=%.4f "
                    "chips=%d -> %s (%.3fs est)", p.n, p.d, p.k, p.sparsity,
                    p.num_chips, name, cost)
        self.chosen = name
        self.costs = {label: c for c, _, label in candidates}
        return make()

    def fit(self, data, labels):
        est = self.optimize(data, labels,
                            getattr(data, "per_shard_count", len(data)))
        return est.fit(data, labels)
