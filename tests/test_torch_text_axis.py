"""The text side of the data axis: gloo ranks on the CPU against one
process and against the JAX package.

`tests/torch_parallel_worker.py::text_axis_job` runs, on 1, 2 and 4
ranks, every text-side fit over a 197-document seeded corpus (a count 2
and 4 ranks pad): the vocabularies (`CommonSparseFeatures`,
`AllSparseFeatures`, `WordFrequencyEncoder`), the sparse datasets on a
mesh (the vectorizer's placed CSR, its gather, sample, densified rows
and padded form), naive Bayes on the CSR and dense, logistic regression,
`SparseLBFGSwithL2` (its forced iterative route on the CSR and on the
padded form, and the Gram route on dense rows), `LeastSquaresEstimator`,
both stupid-backoff estimators, the binary evaluator, and the dense
estimators this slice marks (LDA, ZCA, the approximate PCA, the dual
least squares and `GaussianKernelGenerator`), then the three text
pipelines through their ``run_*`` entry points. World 1 is one process.
Held:

- against one process, bit for bit: the vocabularies, their counts and
  rank orders, the backoff counts and packed tables, the CSR, its
  densified rows, the binary tables, LDA, ZCA, the approximate PCA, the
  dual solve, the kernel generator's anchors and its K5 output (every
  rank's rows, one process's operations), the pipelines' accuracies;
- against one process within a stated share of the largest magnitude
  (float32 sums over ranks in another order; the readings measured at 2
  and 4 ranks are in `ONE_PROCESS_RTOL`'s comments);
- every rank holds the same bits;
- against JAX on a one-device mesh: the three pipelines, naive Bayes,
  logistic regression and LDA at the tolerances
  `tests/test_torch_text_pipelines.py` and `test_torch_classifiers.py`
  use; `SparseLBFGSwithL2` against JAX's sharded route on a mesh of as
  many devices;
- every estimator and evaluator class of the port is mesh-aware.
"""

import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from keystone_tpu.data.dataset import Dataset as JaxDataset
from keystone_tpu.data.sparse import PaddedSparseDataset as JaxPadded
from keystone_tpu.data.sparse import SparseDataset as JaxSparse
from keystone_tpu.nodes.learning import SparseLBFGSwithL2 as JaxSparseLBFGS
from keystone_tpu.nodes.learning.classifiers import (
    LinearDiscriminantAnalysis as JaxLDA,
    NaiveBayesEstimator as JaxNaiveBayes,
    _logreg_fit,
)
from keystone_tpu.parallel.mesh import make_mesh as jax_make_mesh
from keystone_tpu.parallel.mesh import use_mesh as jax_use_mesh
from keystone_tpu.pipelines import text_pipelines as jax_tp

import keystone_tpu_torch
from keystone_tpu_torch.data.dataset import HostDataset
from keystone_tpu_torch.nodes.util.sparse_features import (
    CommonSparseFeatures,
)
from keystone_tpu_torch.pipelines import text_pipelines as tp
from keystone_tpu_torch.workflow.pipeline import Estimator, LabelEstimator

import torch_parallel_worker as worker
from test_torch_classifiers import LDA_TOL, LR_W_REL, NB_LOG_TOL
from test_torch_parallel import shared_root
from test_torch_text_pipelines import LR_OBJECTIVE_REL, SB_TOL, objective64

WORLDS = (2, 4)
D = worker.text_axis_data()

#: bit-equal to one process (keys of the job's arrays)
EQUAL_ARRAYS = (
    "csr_data", "csr_indices", "csr_indptr", "csr_dense", "nb_log_priors",
    "news_log_priors", "lr_preds", "packed_keys", "packed_counts",
    "packed_unigram", "binary", "binary_host", "lda", "zca_whitener",
    "zca_means", "approx_pca", "local_ls", "kgen_anchors", "kgen_out")
#: equal to one process (keys of the job's JSON values)
EQUAL_VALUES = (
    "common_vocab", "all_vocab", "wfe_order", "wfe_counts",
    "backoff_counts", "backoff_unigrams", "packed_vocab", "amazon_vocab",
    "news", "amazon", "backoff", "sparsity", "lse_chosen",
    "slbfgs_dense_route")
#: against one process, a share of the largest magnitude; the comments
#: give the largest reading at 2 and 4 ranks
ONE_PROCESS_RTOL = {
    "nb_log_cond": 1e-6,          # 6.2e-8
    "nb_scores": 1e-6,            # 7.0e-8
    "nb_dense_log_cond": 1e-6,    # 6.2e-8
    "news_log_cond": 1e-6,        # 4.9e-8
    "lr_W": 5e-5,                 # 4.3e-6
    "lr_history": 1e-6,           # 4.3e-8
    "amazon_W": 5e-5,             # 4.2e-6
    # 15 L-BFGS steps from gradients whose float32 sums split over the
    # ranks: the objective agrees to 1.1e-7, W along its flat directions
    # to 2.6e-5
    "slbfgs_W": 1e-4,             # 2.6e-5
    "slbfgs_b": 1e-4,             # 2.9e-5
    "slbfgs_history": 1e-6,       # 1.1e-7
    "slbfgs_padded_W": 1e-4,      # 2.6e-5
    "slbfgs_padded_b": 1e-4,      # 2.9e-5
    "slbfgs_padded_history": 1e-6,  # 1.1e-7
    "slbfgs_dense_W": 1e-4,       # 1.3e-5
    "slbfgs_dense_b": 2e-4,       # 8.9e-5
    "lse_pred": 5e-4,             # 1.4e-4
}
#: port classes with a fit or an evaluate that are not mesh-aware, and
#: why (none: every estimator and evaluator reduces over the data axis)
NOT_MESH_AWARE: dict = {}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    return request.param, worker.run_job(
        "text_axis", request.param, shared_root(tmp_path_factory))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """One process: the same job in a group of one rank."""
    return worker.run_job("text_axis", 1, shared_root(tmp_path_factory))[0]


def _same_on_every_rank(ranks, key):
    first, *rest = [arr[key] for _, arr in ranks[1]]
    for other in rest:
        np.testing.assert_array_equal(other, first)
    return first


def _whole_csr(one):
    arr = one[1]
    return sp.csr_matrix((arr["csr_data"], arr["csr_indices"],
                          arr["csr_indptr"]),
                         shape=(worker.TEXT_N, worker.TEXT_FEATURES))


@pytest.mark.parametrize("key", EQUAL_ARRAYS)
def test_text_side_equals_one_process(ranks, one, key):
    np.testing.assert_array_equal(_same_on_every_rank(ranks, key),
                                  one[1][key])


@pytest.mark.parametrize("key", EQUAL_VALUES)
def test_vocabularies_and_counts_equal_one_process(ranks, one, key):
    for res, _ in ranks[1]:
        assert res[key] == one[0][key], key


@pytest.mark.parametrize("key", sorted(ONE_PROCESS_RTOL))
def test_fit_within_tolerance_of_one_process(ranks, one, key):
    got, want = _same_on_every_rank(ranks, key), one[1][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=ONE_PROCESS_RTOL[key] * np.abs(want).max())


def test_every_rank_holds_the_same_values(ranks):
    """Besides the arrays the tests above read: every JSON value that
    does not name the rank's own rows."""
    first, *rest = [res for res, _ in ranks[1]]
    for other in rest:
        for key, value in first.items():
            if key not in ("csr_placement", "padded"):
                assert other[key] == value, key


def test_sparse_datasets_are_placed_on_the_mesh(ranks, one):
    """Each rank's CSR holds its contiguous share, as `HostDataset.on_mesh`
    places items; the padded form's width is the widest row over every
    rank's (one process's), built from the placed CSR or from the whole
    one."""
    world = ranks[0]
    per = -(-worker.TEXT_N // world)
    width = one[0]["padded"][0]
    for rank, (res, _) in enumerate(ranks[1]):
        lo = min(rank * per, worker.TEXT_N)
        rows = min(per, worker.TEXT_N - lo)
        assert res["csr_placement"] == [rows, worker.TEXT_N, per, lo, True]
        assert res["padded"] == [width, worker.TEXT_N, rows, width,
                                 worker.TEXT_N, True]
    assert one[0]["csr_placement"] == [worker.TEXT_N] * 3 + [0, False]


def test_sample_per_shard_is_one_process_s_sample(ranks, one):
    """k rows a shard at evenly spread global indices, the same rows on
    every rank: one process's sample of k · shards rows."""
    world = ranks[0]
    idx = np.linspace(0, worker.TEXT_N - 1, num=10 * world, dtype=np.int64)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "csr_sample"),
                                  _whole_csr(one).toarray()[idx])


def test_routes_and_shards_on_the_mesh(ranks):
    """`SparseLBFGSwithL2` takes the iterative route on a data axis of
    more than one shard; `LeastSquaresEstimator` prices the mesh's data
    shards."""
    for res, _ in ranks[1]:
        assert res["slbfgs_route"] == "iterative"
        assert res["lse_chips"] == ranks[0]


def test_merges_are_counted_collectives(ranks, one):
    """The merges are `all_gather_object`s over ``data``, counted as the
    other collectives; one process merges nothing."""
    for res, _ in ranks[1]:
        assert res["collectives"]["all_gather_object"] > 0
    assert one[0]["collectives"]["all_gather_object"] == 0


def _port_classes():
    for mod in pkgutil.walk_packages(keystone_tpu_torch.__path__,
                                     "keystone_tpu_torch."):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)

    def below(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from below(sub)

    estimators = {c for base in (Estimator, LabelEstimator)
                  for c in below(base)
                  if c.__module__.startswith("keystone_tpu_torch.")
                  and any("fit" in k.__dict__ for k in c.__mro__
                          if k not in (Estimator, LabelEstimator))}
    from keystone_tpu_torch import evaluation

    evaluators = {c for _, c in inspect.getmembers(evaluation,
                                                   inspect.isclass)
                  if hasattr(c, "evaluate")}
    return estimators, evaluators


def test_every_estimator_and_evaluator_is_mesh_aware():
    """Every port class with a ``fit`` (an `Estimator` or
    `LabelEstimator`) or an ``evaluate`` (the evaluators) is marked
    ``mesh_aware``, or is on `NOT_MESH_AWARE` with its reason."""
    estimators, evaluators = _port_classes()
    assert len(estimators) >= 30 and len(evaluators) >= 4
    unmarked = sorted(f"{c.__module__}.{c.__name__}"
                      for c in estimators | evaluators
                      if not getattr(c, "mesh_aware", False))
    assert unmarked == sorted(NOT_MESH_AWARE), unmarked


# ------------------------------------------------------------------ JAX


@pytest.fixture(scope="module")
def jax_pipelines():
    """JAX's three text pipelines at the job's sizes, one device."""
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        news = jax_tp.run_newsgroups(jax_tp.NewsgroupsConfig(
            n_synth=worker.TEXT_N))
        amazon = jax_tp.run_amazon(jax_tp.AmazonReviewsConfig(
            n_synth=worker.TEXT_N))
        backoff = jax_tp.run_stupid_backoff(jax_tp.StupidBackoffConfig(
            n_synth=worker.TEXT_N))
    return news, amazon, backoff


def test_text_pipelines_across_ranks_match_jax(ranks, jax_pipelines):
    """Newsgroups' test accuracy and training error, Amazon's accuracy
    and F1 equal JAX's; stupid backoff's vocabulary and trigrams equal
    and its mean log score within `SB_TOL`."""
    news, amazon, backoff = jax_pipelines
    for res, _ in ranks[1]:
        assert res["news"] == [news["test_accuracy"], news["train_error"]]
        assert res["amazon"] == [amazon["test_accuracy"], amazon["f1"]]
        assert res["backoff"][:2] == [backoff["vocab"],
                                      backoff["num_trigrams"]]
        assert abs(res["backoff"][2] - backoff["mean_log_score"]) <= SB_TOL


def test_amazon_objective_across_ranks_matches_jax(ranks):
    """The ranks' W, on the training CSR one process builds, gives JAX's
    objective within `LR_OBJECTIVE_REL`."""
    labels, docs = tp.synthetic_corpus(worker.TEXT_N, 2, seed=0)
    n_train = int(0.8 * worker.TEXT_N)
    pairs = tp.text_featurizer()(HostDataset(docs.items[:n_train],
                                             device="cpu")).get()
    X = CommonSparseFeatures(100_000).fit(pairs).apply_batch(pairs).matrix
    y = np.asarray(labels.items[:n_train], np.int64)
    jlabels, jdocs = jax_tp.synthetic_corpus(worker.TEXT_N, 2, seed=0)
    assert jlabels.items == labels.items and jdocs.items == docs.items
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        W_jax = np.asarray(_logreg_fit(
            jnp.asarray(X.toarray()), jnp.asarray(y),
            jnp.ones(n_train, jnp.float32), jnp.float32(1e-3), 2, 50))
    want = objective64(X, y, W_jax, 1e-3)
    got = objective64(X, y, _same_on_every_rank(ranks, "amazon_W"), 1e-3)
    assert abs(got / want - 1.0) <= LR_OBJECTIVE_REL


def test_naive_bayes_across_ranks_matches_jax(ranks, one):
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        want = JaxNaiveBayes(worker.TEXT_CLASSES).fit(
            JaxSparse(_whole_csr(one)), np.asarray(D["labels"]))
    for key, ref in (("nb_log_priors", want.log_priors),
                     ("nb_log_cond", want.log_cond)):
        np.testing.assert_allclose(_same_on_every_rank(ranks, key),
                                   np.asarray(ref), rtol=0, atol=NB_LOG_TOL)


def test_logistic_regression_across_ranks_matches_jax(ranks, one):
    """`_logreg_fit` on the densified CSR at the job's 15 steps: W within
    `LR_W_REL` of max|W|, the same predictions."""
    X = _whole_csr(one).toarray()
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        W = np.asarray(_logreg_fit(
            jnp.asarray(X), jnp.asarray(np.asarray(D["labels"])),
            jnp.ones(worker.TEXT_N, jnp.float32), jnp.float32(1e-3),
            worker.TEXT_CLASSES, worker.TEXT_ITERS))
    got = _same_on_every_rank(ranks, "lr_W")
    np.testing.assert_allclose(got, W, rtol=0,
                               atol=LR_W_REL * np.abs(W).max())
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "lr_preds"),
                                  np.argmax(X @ W, axis=1))


def test_lda_across_ranks_matches_jax(ranks):
    with jax_use_mesh(jax_make_mesh(jax.devices()[:1])):
        want = JaxLDA(2).fit(JaxDataset(D["X3"]), JaxDataset(D["y3"]))
    np.testing.assert_allclose(_same_on_every_rank(ranks, "lda"),
                               np.asarray(want.components), rtol=0,
                               atol=LDA_TOL)


#: the port's iterative route on 2 or 4 ranks against JAX's sharded route
#: on as many devices, a share of max|W| (and of max|b|)
SHARDED_RTOL = 1e-4


def test_sparse_lbfgs_across_ranks_matches_jax_sharded(ranks, one):
    """JAX's `_lbfgs_sparse_matvec_fit_sharded` (a `PaddedSparseDataset`
    under a mesh of as many devices as ranks) against the ranks'
    iterative route on the padded form and on the CSR."""
    world = ranks[0]
    with jax_use_mesh(jax_make_mesh(jax.devices()[:world])):
        model = JaxSparseLBFGS(worker.TEXT_LAM, worker.TEXT_ITERS,
                               method="iterative").fit(
            JaxPadded.from_csr(_whole_csr(one)), D["Yi"])
    W, b = np.asarray(model.W), np.asarray(model.b)
    for name in ("slbfgs", "slbfgs_padded"):
        np.testing.assert_allclose(
            _same_on_every_rank(ranks, f"{name}_W"), W, rtol=0,
            atol=SHARDED_RTOL * np.abs(W).max())
        np.testing.assert_allclose(
            _same_on_every_rank(ranks, f"{name}_b"), b, rtol=0,
            atol=SHARDED_RTOL * np.abs(b).max())
