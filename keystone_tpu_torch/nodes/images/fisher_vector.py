"""Fisher vector encoding.

Counterpart of `keystone_tpu/nodes/images/fisher_vector.py` (`:25-157`;
reference nodes/images/FisherVector.scala:14-94, the Sanchez et al.
closed form over GMM posteriors, :33-53, and the enceval route,
external/FisherVector.scala:17-55). Each descriptor matrix (nd, d)
becomes (d, 2k): the posteriors (an nd × k GEMM), then the first- and
second-order statistics, two more GEMMs. Where the JAX package encodes
host items one jitted call at a time (`:64-65`), the port computes the
same function over a bucket of equal-shape matrices at once, as batched
matrix products.
"""

from __future__ import annotations

import torch

from ...workflow.pipeline import Estimator, OptimizableEstimator, Transformer
from ..learning.gmm import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
    log_gauss_posteriors,
)


def fisher_vectors(X: torch.Tensor, means: torch.Tensor,
                   variances: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """(b, nd, d) descriptor matrices → (b, d, 2k) Fisher vectors, the
    reference's DenseMatrix[d, 2k] layout: mean gradients, then sigma
    gradients."""
    nd = X.shape[1]
    q = torch.exp(log_gauss_posteriors(X, means, variances, weights))
    qT = q.transpose(1, 2)               # (b, k, nd)
    S0 = q.sum(dim=1)[..., None]         # (b, k, 1)
    S1 = qT @ X                          # (b, k, d)
    S2 = qT @ (X * X)
    w = weights[:, None]
    g_mu = (S1 - means * S0) / (torch.sqrt(variances) * torch.sqrt(w) * nd)
    g_sig = ((S2 - 2.0 * means * S1 + (means ** 2 - variances) * S0)
             / (variances * torch.sqrt(2.0 * w) * nd))
    return torch.cat([g_mu.transpose(1, 2), g_sig.transpose(1, 2)], dim=2)


def _fv_fit_spec(k: int, label: str):
    """TransformerSpec of a to-be-fitted FV encoder
    (`keystone_tpu/nodes/images/fisher_vector.py:75-92`): descriptor
    matrix (nd, d) → (d, 2k) float32, decidable before the GMM fit."""
    from ...analysis.specs import (
        SpecMismatchError,
        TransformerSpec,
        shape_struct,
    )

    def elem_fn(elem):
        if getattr(elem, "ndim", 0) != 2:
            raise SpecMismatchError(
                f"{label} input element must be a 2-D descriptor matrix")
        return shape_struct((int(elem.shape[-1]), 2 * k), torch.float32)

    return TransformerSpec(elem_fn, label=label)


def _fv_apply_flops(k: int, in_elem) -> "float | None":
    """≈8·nd·d·k an item (`:95-107`): the posterior GEMM, the two
    aggregation GEMMs and the elementwise work; the roofline's generic
    dense in×out model would charge descriptor rows against output
    rows."""
    from ...analysis.specs import tree_leaves

    leaves = tree_leaves(in_elem)
    if len(leaves) != 1 or getattr(leaves[0], "ndim", 0) != 2:
        return None
    nd, d = leaves[0].shape
    return 8.0 * float(nd) * float(d) * float(k)


class FisherVector(Transformer):
    """Descriptor matrix (nd, d) → FV matrix (d, 2k)
    (FisherVector.scala:14-62)."""

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm

    def batch_fn(self):
        g = self.gmm
        return lambda X: fisher_vectors(X.to(torch.float32), g.means,
                                        g.variances, g.weights)


class ScalaGMMFisherVectorEstimator(Estimator):
    """A GMM fit on descriptor samples, returned as its FV encoder
    (FisherVector.scala:69-84). On a mesh the GMM sees the descriptor
    sample one process sees (`GaussianMixtureModelEstimator`)."""

    mesh_aware = True  # the GMM's fit collects over the data axis

    def __init__(self, k: int, num_iters: int = 30, seed: int = 0):
        self.k = k
        self.num_iters = num_iters
        self.seed = seed

    def abstract_fit(self, in_specs):
        return _fv_fit_spec(self.k, self.label)

    def abstract_apply_flops(self, in_elem, out_elem):
        return _fv_apply_flops(self.k, in_elem)

    def fit(self, data) -> FisherVector:
        return FisherVector(GaussianMixtureModelEstimator(
            self.k, num_iters=self.num_iters, seed=self.seed).fit(data))


#: the reference's enceval route is the same computation here
EncEvalGMMFisherVectorEstimator = ScalaGMMFisherVectorEstimator


class GMMFisherVectorEstimator(OptimizableEstimator):
    """The reference's optimizable FV estimator (FisherVector.scala:
    86-94): both of its routes are one computation, so it fits its
    default."""

    mesh_aware = True  # its default is

    def __init__(self, k: int, num_iters: int = 30, seed: int = 0):
        self.k = k
        self.num_iters = num_iters
        self.seed = seed

    def abstract_fit(self, in_specs):
        return _fv_fit_spec(self.k, self.label)

    def abstract_apply_flops(self, in_elem, out_elem):
        return _fv_apply_flops(self.k, in_elem)

    @property
    def default(self) -> Estimator:
        return ScalaGMMFisherVectorEstimator(self.k, self.num_iters,
                                             self.seed)

    def optimize(self, sample, num_per_shard) -> Estimator:
        """Both routes are one computation (`fisher_vector.py:156-157`)."""
        return self.default
