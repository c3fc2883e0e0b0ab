"""PCA, k-means++, the GMM and Fisher vectors: the port against the JAX
package on the CPU.

- PCA: the components, sign-fixed by the reference's convention, within
  ``PCA_ATOL`` of JAX's local PCA, for the local fit (QR then the SVD of
  R, where JAX takes the SVD of the rows), the one-device distributed
  form (against JAX's TSQR on the tests' 8-device mesh) and
  `ColumnPCAEstimator`; the randomized sketch by subspace angle.
- k-means++: the seeding draws the very rows numpy's draws pick.
- k-means and the GMM: both packages fit the same X from the same
  numpy seed; the centers within ``KMEANS_RTOL`` and the mixture within
  ``GMM_RTOL`` of JAX's after 20 Lloyd and 30 EM steps. Measured, as a
  share of the largest entry: centers 1.4e-7; after 30 EM steps from the
  k-means++ start means 3.0e-7, variances 5.5e-7, weights 7.4e-8, and
  from the random start up to 2.1e-6: the start agrees to rounding, and
  30 steps carry that difference up about tenfold, not more.
- Posteriors and Fisher vectors on the repository's VOC codebook
  (`tests/resources/voc_codebook/`, 256 components in 80 dimensions,
  variances 1.9 to 47,918), against JAX's `_log_gauss_posteriors` and
  `_fisher_vector`. The three-GEMM Mahalanobis form cancels there: both
  packages' posteriors lie 4.1e-5 from a float64 evaluation of the same
  form and 1.9e-5 to 3e-5 from each other, so they are held to
  ``POSTERIOR_ATOL``; the Fisher vectors, which carry them, differ by
  2.5e-5 of their largest entry and are held to ``FV_RTOL`` of it.
"""

import os

import numpy as np
import pytest
import torch

from keystone_tpu.data.dataset import (
    Dataset as JaxDataset,
    HostDataset as JaxHostDataset,
)
from keystone_tpu.nodes.images.fisher_vector import (
    FisherVector as JaxFisherVector,
)
from keystone_tpu.nodes.learning.gmm import (
    GaussianMixtureModel as JaxGMM,
    GaussianMixtureModelEstimator as JaxGMMEstimator,
)
from keystone_tpu.nodes.learning.kmeans import (
    KMeansPlusPlusEstimator as JaxKMeans,
    kmeans_pp_init as jax_kmeans_pp_init,
)
from keystone_tpu.nodes.learning.pca import (
    ApproximatePCAEstimator as JaxApproximatePCA,
    ColumnPCAEstimator as JaxColumnPCA,
    DistributedPCAEstimator as JaxDistributedPCA,
    PCAEstimator as JaxPCA,
)
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.nodes.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
)
from keystone_tpu_torch.nodes.learning.gmm import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
)
from keystone_tpu_torch.nodes.learning.kmeans import (
    KMeansPlusPlusEstimator,
    kmeans_pp_init,
)
from keystone_tpu_torch.nodes.learning.pca import (
    ApproximatePCAEstimator,
    ColumnPCAEstimator,
    DistributedPCAEstimator,
    PCAEstimator,
)

CODEBOOK = os.path.join(os.path.dirname(__file__), "resources",
                        "voc_codebook")
PCA_ATOL = 2e-5
SUBSPACE_COS = 1.0 - 1e-5
KMEANS_RTOL = 1e-5
GMM_RTOL = 1e-4
POSTERIOR_ATOL = 1e-4
FV_RTOL = 1e-4


def _spectrum_rows(n, d, seed=0, gap=0):
    """Rows with a spread spectrum (scales 3 down to 0.2), so each
    component is well defined; with ``gap`` the first ``gap`` scales are
    ten times larger."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = np.linspace(3.0, 0.2, d)
    scales[:gap] *= 10.0
    return ((rng.normal(size=(n, d)) * scales) @ Q.T + 1.5).astype(
        np.float32)


def _descriptor_items(n_items, rows, d, seed=1):
    X = _spectrum_rows(n_items * rows, d, seed)
    return [X[i * rows:(i + 1) * rows] for i in range(n_items)]


def _comps(transformer):
    c = transformer.components
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def test_local_pca_matches_jax_on_vectors_and_a_row_cap():
    X = _spectrum_rows(400, 12)
    want = _comps(JaxPCA(5).fit(JaxDataset(X)))
    got = _comps(PCAEstimator(5).fit(Dataset(X, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=0, atol=PCA_ATOL)
    # above sample_rows both keep the same linspace rows
    want = _comps(JaxPCA(5, sample_rows=150).fit(JaxDataset(X)))
    got = _comps(PCAEstimator(5, sample_rows=150).fit(
        Dataset(X, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=0, atol=PCA_ATOL)


@pytest.mark.parametrize("estimator,jax_estimator", [
    (PCAEstimator(6), JaxPCA(6)),
    (DistributedPCAEstimator(6), JaxDistributedPCA(6)),
    (ColumnPCAEstimator(6), JaxColumnPCA(6)),
], ids=["local", "distributed", "column"])
def test_pca_matches_jax_on_descriptor_matrices(estimator, jax_estimator):
    items = _descriptor_items(30, 13, 16)
    want = jax_estimator.fit(JaxHostDataset(items))
    got = estimator.fit(HostDataset(items, device="cpu"))
    np.testing.assert_allclose(_comps(got), _comps(want), rtol=0,
                               atol=PCA_ATOL)
    # applied to a descriptor matrix: the last axis is projected
    np.testing.assert_allclose(got.apply(items[0]).numpy(),
                               np.asarray(want.apply(items[0])), rtol=0,
                               atol=PCA_ATOL * np.abs(items[0]).sum(1).max())


def test_distributed_pca_on_vectors_matches_jax_tsqr():
    X = _spectrum_rows(320, 10, seed=2)
    want = _comps(JaxDistributedPCA(4).fit(JaxDataset(X)))
    got = _comps(DistributedPCAEstimator(4).fit(Dataset(X, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=0, atol=PCA_ATOL)


def _min_cos(A, B):
    """Cosine of the largest principal angle between two column
    spaces."""
    qa, _ = np.linalg.qr(A)
    qb, _ = np.linalg.qr(B)
    return np.linalg.svd(qa.T @ qb, compute_uv=False).min()


def test_approximate_pca_spans_jax_subspace():
    """The sketches draw different Gaussian test matrices (torch's
    generator, `jax.random`), so the fits agree by subspace: the top four
    of a spectrum with a gap after them."""
    X = _spectrum_rows(500, 20, seed=3, gap=4)
    want = _comps(JaxApproximatePCA(4, q=2).fit(JaxDataset(X)))
    got = _comps(ApproximatePCAEstimator(4, q=2).fit(
        Dataset(X, device="cpu")))
    exact = _comps(PCAEstimator(4).fit(Dataset(X, device="cpu")))
    assert got.shape == want.shape == (20, 4)
    assert _min_cos(got, want) >= SUBSPACE_COS
    assert _min_cos(got, exact) >= SUBSPACE_COS


def _blobs(n, d, k, seed=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, d))
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(500, 16, 8), (3000, 32, 64),
                                   (2000, 80, 256)])
def test_kmeans_pp_init_draws_numpys_rows(n, d, k):
    X = _blobs(n, d, min(k, 16))
    want = jax_kmeans_pp_init(X, k, np.random.default_rng(11))
    got = kmeans_pp_init(torch.from_numpy(X), k, np.random.default_rng(11))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_matches_jax_on_the_same_rows():
    X = _blobs(1200, 8, 6)
    want = np.asarray(JaxKMeans(6, seed=2).fit(JaxDataset(X)).centers)
    model = KMeansPlusPlusEstimator(6, seed=2).fit(Dataset(X, device="cpu"))
    np.testing.assert_allclose(model.centers.numpy(), want,
                               rtol=KMEANS_RTOL, atol=KMEANS_RTOL)
    onehot = model.apply_batch(Dataset(X[:50], device="cpu")).numpy()
    np.testing.assert_array_equal(onehot.sum(1), np.ones(50))


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_gmm_estimator_matches_jax_on_the_same_rows(init):
    items = [_blobs(40, 6, 4, seed=5 + i) for i in range(30)]
    want = JaxGMMEstimator(4, init=init, seed=3).fit(JaxHostDataset(items))
    got = GaussianMixtureModelEstimator(4, init=init, seed=3).fit(
        HostDataset(items, device="cpu"))
    for name in ("means", "variances", "weights"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                   rtol=GMM_RTOL,
                                   atol=GMM_RTOL * np.abs(w).max())


def test_gmm_row_cap_keeps_jax_rows():
    X = _blobs(900, 5, 3, seed=9)
    want = JaxGMMEstimator(3, seed=1, max_rows=250).fit(JaxDataset(X))
    got = GaussianMixtureModelEstimator(3, seed=1, max_rows=250).fit(
        Dataset(X, device="cpu"))
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means),
                               rtol=GMM_RTOL,
                               atol=GMM_RTOL * float(np.abs(want.means).max()))


@pytest.fixture(scope="module")
def codebook():
    paths = [os.path.join(CODEBOOK, f) for f in
             ("means.csv", "variances.csv", "priors")]
    return JaxGMM.load_csv(*paths), GaussianMixtureModel.load_csv(
        *paths, device="cpu")


def _codebook_descriptors(gmm, n_items, rows, seed=7):
    """Rows drawn from the codebook's own components."""
    rng = np.random.default_rng(seed)
    means, var = np.asarray(gmm.means), np.asarray(gmm.variances)
    comp = rng.integers(0, means.shape[0], size=(n_items, rows))
    x = means[comp] + np.sqrt(var[comp]) * rng.normal(size=comp.shape
                                                      + (means.shape[1],))
    return x.astype(np.float32)


def test_codebook_loads_transposed_as_jax(codebook):
    jax_gmm, gmm = codebook
    assert gmm.means.shape == (256, 80) and gmm.k == 256
    for name in ("means", "variances", "weights"):
        np.testing.assert_array_equal(getattr(gmm, name).numpy(),
                                      np.asarray(getattr(jax_gmm, name)))


def test_posteriors_match_jax_on_the_codebook(codebook):
    jax_gmm, gmm = codebook
    X = _codebook_descriptors(jax_gmm, 1, 300)[0]
    want = np.asarray(jax_gmm.posteriors(X))
    got = gmm.posteriors(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=POSTERIOR_ATOL)
    thresholded = gmm.apply(X[0]).numpy()
    np.testing.assert_allclose(thresholded, np.asarray(jax_gmm.apply(X[0])),
                               rtol=0, atol=POSTERIOR_ATOL)


def test_fisher_vectors_match_jax_on_the_codebook(codebook):
    """A bucket of eight 52 × 80 descriptor matrices (VOC's 52 SIFT
    descriptors an image, projected to 80) in one batched call, against
    JAX's one-item calls: (80, 512) each."""
    jax_gmm, gmm = codebook
    X = _codebook_descriptors(jax_gmm, 8, 52)
    want = np.stack([np.asarray(JaxFisherVector(jax_gmm).apply(x))
                     for x in X])
    got = FisherVector(gmm).apply_batch(HostDataset(list(X), device="cpu"))
    got = np.stack([x.numpy() for x in got.items])
    assert got.shape == want.shape == (8, 80, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FV_RTOL * np.abs(want).max())


def test_gmm_fisher_vector_estimator_fits_and_encodes():
    items = [_blobs(20, 6, 3, seed=20 + i) for i in range(12)]
    encoder = GMMFisherVectorEstimator(3).fit(HostDataset(items,
                                                          device="cpu"))
    out = encoder.apply_batch(HostDataset(items, device="cpu"))
    assert out.items[0].shape == (6, 6)
    assert GMMFisherVectorEstimator(3).default.k == 3
