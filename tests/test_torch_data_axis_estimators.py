"""The image estimators and evaluators on the data axis: gloo ranks on
the CPU against one process and against the JAX package.

`tests/torch_parallel_worker.py::estimators_job` fits every estimator and
evaluator that takes a row-sharded dataset since this slice (KRR and its
blocked apply, local, TSQR and column-chosen PCA, k-means++, the GMM and
its Fisher-vector estimator, both class-weighted solvers, the augmented
and mAP evaluators) on 1, 2 and 4 ranks over 197 rows (a count 2 and 4
ranks pad), ragged descriptor matrices, and a 9-row BWLS set whose last
of four ranks holds no valid row. World 1 is one process. Held:

- against one process: the gathers bit-equal to indexing; KRR's alpha
  and predictions, k-means, the GMM, the evaluators bit-equal (the blocks
  and samples are one process's rows); TSQR within 1e-4 of max|V| up to
  sign (the R factors of each rank's rows, stacked); BWLS within 1e-5 of
  max|W| (rank partial sums in another order; measured 3.1e-6), the
  single-block per-class solve at λ 0.1 within 3e-5 (measured 1.1e-5);
- against JAX on a one-device mesh (ROADMAP ground rules), with the
  tolerance each test states;
- every rank holds the same bits;
- naive Bayes and the binary evaluator fit and score the same placed
  rows across ranks (the text side's data axis:
  `tests/test_torch_text_axis.py`).

`estimator_pipelines_job` runs RandomPatchCifarKernel (on JAX's filters,
carried across, and on its own), the augmented pair, VOCSIFTFisher and
ImageNetSiftLcsFV at small sizes on one rank and on two, each held to one
process, and the kernel pipeline, VOC and ImageNet to JAX.
"""

import os

import jax
import numpy as np
import pytest

from keystone_tpu.data.dataset import (
    Dataset as JaxDataset,
    HostDataset as JaxHostDataset,
)
from keystone_tpu.evaluation import (
    AugmentedExamplesEvaluator as JaxAugmented,
    MeanAveragePrecisionEvaluator as JaxMAP,
)
from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.images import (
    ScalaGMMFisherVectorEstimator as JaxFVEstimator,
)
from keystone_tpu.nodes.images.core import (
    Convolver as JaxConvolver,
    ImageVectorizer as JaxImageVectorizer,
    PixelScaler as JaxPixelScaler,
    Pooler as JaxPooler,
    SymmetricRectifier as JaxSymmetricRectifier,
)
from keystone_tpu.nodes.learning import (
    BlockWeightedLeastSquaresEstimator as JaxBWLS,
    ColumnPCAEstimator as JaxColumnPCA,
    DistributedPCAEstimator as JaxTSQR,
    GaussianMixtureModelEstimator as JaxGMM,
    KernelRidgeRegression as JaxKRR,
    KMeansPlusPlusEstimator as JaxKMeans,
    PCAEstimator as JaxPCA,
    PerClassWeightedLeastSquares as JaxPerClass,
)
from keystone_tpu.nodes.stats import StandardScaler as JaxStandardScaler
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromInt as JaxIndicators,
)
from keystone_tpu.nodes.util.fusion import (
    FusedBatchTransformer as JaxFusedBatchTransformer,
)
from keystone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from keystone_tpu.parallel.mesh import use_mesh as jax_use_mesh
from keystone_tpu.pipelines import imagenet_sift_lcs_fv as jax_imagenet
from keystone_tpu.pipelines import voc_sift_fisher as jax_voc
from keystone_tpu.pipelines.cifar_variants import (
    RandomPatchCifarKernelConfig as JaxKernelConfig,
)
from keystone_tpu.pipelines.random_patch_cifar import (
    learn_filters as jax_learn_filters,
)

import torch_parallel_worker as worker
from test_torch_parallel import shared_root

WORLDS = (2, 4)
D = worker.estimator_data()

#: against the port on one process, a share of the largest magnitude;
#: 0 is bit-equal
ONE_PROCESS_RTOL = {
    "krr_alpha": 0.0, "krr_pred": 0.0, "krr_pred_b50": 0.0,
    "pca_local": 0.0, "kmeans": 0.0, "gmm_means": 0.0, "gmm_vars": 0.0,
    "gmm_wts": 0.0, "fv_means": 0.0, "aug_mean": 0.0, "aug_max": 0.0,
    "aug_borda": 0.0, "map": 0.0, "map_host": 0.0,
    "bwls_W": 1e-5, "bwls_b": 1e-5, "bwls_small_W": 1e-5,
    "bwls_small_b": 1e-5, "perclass_W": 3e-5, "perclass_b": 3e-5,
}
#: TSQR's components, up to each column's sign
TSQR_ATOL = 1e-4


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    return request.param, worker.run_job(
        "estimators", request.param, shared_root(tmp_path_factory))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """One process: the same job in a group of one rank."""
    return worker.run_job("estimators", 1, shared_root(tmp_path_factory))[0]


def _same_on_every_rank(ranks, key):
    first, *rest = [arr[key] for _, arr in ranks[1]]
    for other in rest:
        np.testing.assert_array_equal(other, first)
    return first


def _close(got, want, rtol, what=""):
    assert got.shape == want.shape, what
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                   atol=rtol * float(np.abs(want).max()))


def _up_to_sign(got, want, atol):
    signs = np.sign((got * want).sum(axis=0))
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=atol)


@pytest.mark.parametrize("key", sorted(ONE_PROCESS_RTOL))
def test_estimator_matches_one_process(ranks, one, key):
    _close(_same_on_every_rank(ranks, key), one[1][key],
           ONE_PROCESS_RTOL[key], key)


@pytest.mark.parametrize("key", ["pca_tsqr", "pca_tsqr_desc"])
def test_tsqr_across_ranks_matches_one_process(ranks, one, key):
    _up_to_sign(_same_on_every_rank(ranks, key), one[1][key], TSQR_ATOL)


def test_row_gathers_equal_one_process_indexing(ranks):
    ids = np.random.default_rng(5).integers(0, 197, size=40)
    ids[-3:] = ids[:3]
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "gather_rows"),
                                  D["X"][ids])
    rows = np.concatenate(D["desc"])
    idx = np.linspace(0, len(rows) - 1, 100, dtype=np.int64)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "collect_rows"),
                                  rows[idx])
    for res, _ in ranks[1]:
        # gather_rows: one all_gather; collect_rows: the counts' all-reduce
        # and one all_gather
        assert res["row_gathers"] == {"all_gather": 2.0, "all_reduce": 1.0}


def test_row_gather_without_a_mesh_is_this_process_s_indexing(ranks):
    """`gather_rows(..., None)` indexes the rows it is given, with no
    collective, though every rank has a group and a current mesh."""
    ids = np.random.default_rng(5).integers(0, 197, size=40)
    ids[-3:] = ids[:3]
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "gather_rows_no_mesh"), D["X"][ids])


def test_guard_still_raises_for_the_text_side(ranks, one):
    """The guard lets the text side through: NaiveBayesEstimator fits and
    BinaryClassifierEvaluator scores the placed rows without raising,
    every rank's log-priors and table equal to one process's and its
    log-conditionals within 1e-6 of their largest magnitude (float32
    class sums over ranks; measured 1.4e-7)."""
    for res, _ in ranks[1]:
        assert res["guard_naive_bayes"] == res["guard_binary"] == ""
    for key in ("nb_log_priors", "binary_table"):
        np.testing.assert_array_equal(_same_on_every_rank(ranks, key),
                                      one[1][key])
    want = one[1]["nb_log_cond"]
    np.testing.assert_allclose(_same_on_every_rank(ranks, "nb_log_cond"),
                               want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_one_rank_fits_without_raising(one):
    assert one[0]["guard_naive_bayes"] == one[0]["guard_binary"] == ""


# ------------------------------------------------------------------ JAX


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's fits of the same inputs on a one-device mesh."""
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        X, Y = JaxDataset(D["X"]), JaxDataset(D["Y"])
        out = {}
        krr = JaxKRR(**worker.KRR_CFG).fit(X, Y)
        out["krr_alpha"] = np.asarray(krr.alpha)
        out["krr_pred"] = krr.apply_batch(JaxDataset(D["Xt"])).numpy()
        out["pca_local"] = np.asarray(JaxPCA(4, sample_rows=150).fit(
            X).components)
        out["pca_tsqr"] = np.asarray(JaxTSQR(4).fit(X).components)
        out["pca_tsqr_desc"] = np.asarray(JaxTSQR(3).fit(
            JaxHostDataset(D["desc"])).components)
        out["kmeans"] = np.asarray(JaxKMeans(4, 10, seed=1).fit(X).centers)
        g = JaxGMM(3, num_iters=5, max_rows=150).fit(X)
        out["gmm_means"] = np.asarray(g.means)
        out["fv_means"] = np.asarray(JaxFVEstimator(3, num_iters=4).fit(
            JaxHostDataset(D["desc"])).gmm.means)
        bw = JaxBWLS(4, 2, 0.1).fit(X, Y)
        out["bwls_W"] = np.asarray(bw.W)
        small = JaxBWLS(3, 2, 0.5, 0.3).fit(JaxDataset(D["Xs"]),
                                            JaxDataset(D["Ys"]))
        out["bwls_small_W"] = np.asarray(small.W)
        out["perclass_W"] = np.asarray(JaxPerClass(0.1).fit(X, Y).W)
        for agg in ("mean", "max", "borda"):
            out[f"aug_{agg}"] = np.asarray(JaxAugmented(4, agg)(
                D["ids"], D["scores"], D["labels"]).confusion)
        out["map"] = np.asarray(JaxMAP(4)(D["scores"], D["actual_lists"]))
    return out


#: against JAX: the share of the largest magnitude each is held to (the
#: port's own one-process tests hold the same estimators to these)
JAX_RTOL = {"krr_alpha": 1e-4, "krr_pred": 1e-4, "pca_local": 1e-4,
            "kmeans": 1e-4, "gmm_means": 1e-3, "fv_means": 1e-3,
            "bwls_W": 1e-4, "bwls_small_W": 1e-4, "perclass_W": 1e-4,
            "aug_mean": 0.0, "aug_max": 0.0, "aug_borda": 0.0, "map": 0.0}


@pytest.mark.parametrize("key", sorted(JAX_RTOL))
def test_estimator_across_ranks_matches_jax(ranks, jax_ref, key):
    got = _same_on_every_rank(ranks, key)
    want = jax_ref[key]
    if JAX_RTOL[key] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=JAX_RTOL[key] * np.abs(want).max())


@pytest.mark.parametrize("key", ["pca_tsqr", "pca_tsqr_desc"])
def test_tsqr_across_ranks_matches_jax(ranks, jax_ref, key):
    _up_to_sign(_same_on_every_rank(ranks, key), jax_ref[key], TSQR_ATOL)


def test_column_pca_choice_equals_jax_on_the_same_mesh(ranks):
    """`ColumnPCAEstimator.optimize` reads the mesh's data shards as JAX
    reads its own (`pca.py:309-327`): the same choice on a mesh of as
    many devices."""
    world = ranks[0]
    with jax_use_mesh(jax_make_mesh(jax.devices()[:world])):
        est = JaxColumnPCA(3)
        est.optimize(JaxHostDataset(D["desc"][:3 * world]), 10)
    got = bool(_same_on_every_rank(ranks, "column_pca_local"))
    assert got == (est.chosen == "local")


# ------------------------------------------------------------ pipelines


def _make_pipeline_reference(out_dir):
    """JAX's RandomPatchCifarKernel filters, fit and test scores on a
    one-device mesh, and its VOC and ImageNet runs."""
    n_train, n_test = worker.KERNEL_CIFAR_N
    jtrain, jtest = jax_synthetic(n_train, n_test, noise=1.2, confusion=0.6)
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        config = JaxKernelConfig(**worker.KERNEL_CIFAR_CFG)
        filters, whitener = jax_learn_filters(jtrain.data, config)
        featurizer = JaxFusedBatchTransformer(
            [JaxPixelScaler(),
             JaxConvolver(filters, 32, 32, 3, whitener=whitener),
             JaxSymmetricRectifier(alpha=config.alpha),
             JaxPooler(config.pool_stride, config.pool_size, pool_fn="sum"),
             JaxImageVectorizer()], microbatch=config.microbatch)
        feats = featurizer.apply_batch(jtrain.data)
        scaler = JaxStandardScaler().fit(feats)
        model = JaxKRR(config.gamma, config.lam, config.kernel_block,
                       config.kernel_epochs).fit(
            scaler.apply_batch(feats),
            JaxIndicators(10).apply_batch(jtrain.labels))
        scores = model.apply_batch(scaler.apply_batch(
            featurizer.apply_batch(jtest.data))).numpy()
        voc = jax_voc.run(jax_voc.VOCSIFTFisherConfig(**worker.VOC_CFG))
        imagenet = jax_imagenet.run(jax_imagenet.ImageNetSiftLcsFVConfig(
            **worker.IMAGENET_CFG))
    np.savez(os.path.join(out_dir, "jax.npz"), filters=np.asarray(filters),
             whitener=np.asarray(whitener.whitener),
             means=np.asarray(whitener.means), scores=np.asarray(scores),
             voc_map=np.float64(voc["map"]),
             imagenet_accuracy=np.float64(imagenet["test_accuracy"]))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """(JAX's reference, one process's results, two ranks' results)."""
    root = shared_root(tmp_path_factory)
    ref = worker.once(root, "estimator-pipelines-reference",
                      _make_pipeline_reference)
    jax_out = dict(np.load(os.path.join(ref, "jax.npz")))
    return (jax_out, worker.run_job("estimator_pipelines", 1, root)[0],
            worker.run_job("estimator_pipelines", 2, root))


def _pipeline_arrays(pipelines, key):
    return pipelines[1][1][key], [arr[key] for _, arr in pipelines[2]]


def test_kernel_cifar_on_two_ranks_matches_jax_and_one_process(pipelines):
    """JAX's filters carried across: two ranks' test scores have JAX's
    argmax and lie within 1e-4 of its largest score (as one process's
    do, `tests/test_torch_cifar_variants.py`), and equal one process's
    within 1e-5."""
    want = pipelines[0]["scores"]
    one, two = _pipeline_arrays(pipelines, "kernel_scores")
    for got in [one] + two:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    for got in two:
        np.testing.assert_allclose(got, one, rtol=0,
                                   atol=1e-5 * np.abs(one).max())


def test_kernel_cifar_own_filters_on_two_ranks_equal_one_process(pipelines):
    """The port's own draws: filters learned once and broadcast, so two
    ranks predict as one process."""
    one, two = _pipeline_arrays(pipelines, "kernel_own_preds")
    for got in two:
        np.testing.assert_array_equal(got, one)
    accs = {res["kernel_own_accuracy"] for res, _ in pipelines[2]}
    assert accs == {pipelines[1][0]["kernel_own_accuracy"]}


@pytest.mark.parametrize("name", ["aug_kernel", "aug"])
def test_augmented_on_two_ranks_equals_one_process(pipelines, name):
    """Crops (for the kernel variant also flips and the shuffle) drawn
    once in global order, placed on the ranks: the test confusion over
    the views of each image (ten, five) and the training error equal one
    process's."""
    one, two = _pipeline_arrays(pipelines, f"{name}_confusion")
    for got in two:
        np.testing.assert_array_equal(got, one)
    for res, _ in pipelines[2]:
        assert res[f"{name}_train_error"] == \
            pipelines[1][0][f"{name}_train_error"]


def test_voc_on_two_ranks_matches_jax_and_one_process(pipelines):
    """VOCSIFTFisher: each rank's SIFT and Fisher vectors, the PCA and GMM
    fits on one process's sample, BWLS over both ranks' rows. The mAP
    equals one process's and lies within 1e-3 of JAX's. Against one
    process: the PCA within 1e-4 up to sign (measured 6.1e-5: the column
    PCA priced on two shards), the GMM means and the scores within 1e-4
    of their largest (2.5e-5, 9.4e-6), W within 1e-3 (2.0e-4: the
    class-weighted solve amplifies the PCA's difference; the one-process
    port's W lies 9.0e-4 from JAX's, `tests/test_torch_sift_fisher.py`)."""
    jax_map = float(pipelines[0]["voc_map"])
    one_res = pipelines[1][0]
    for res, _ in pipelines[2]:
        assert abs(res["voc_map"] - one_res["voc_map"]) <= 1e-6
        assert abs(res["voc_map"] - jax_map) <= 1e-3
    one, two = _pipeline_arrays(pipelines, "voc_pca")
    for got in two:
        _up_to_sign(got, one, 1e-4)
    for key, rtol in (("voc_gmm_means", 1e-4), ("voc_W", 1e-3),
                      ("voc_scores", 1e-4)):
        one, two = _pipeline_arrays(pipelines, key)
        for got in two:
            np.testing.assert_allclose(got, one, rtol=0,
                                       atol=rtol * np.abs(one).max())


def test_imagenet_on_two_ranks_matches_jax_and_one_process(pipelines):
    jax_acc = float(pipelines[0]["imagenet_accuracy"])
    for res, _ in pipelines[2]:
        assert res["imagenet_accuracy"] == \
            pipelines[1][0]["imagenet_accuracy"]
        assert abs(res["imagenet_accuracy"] - jax_acc) <= 0.01
