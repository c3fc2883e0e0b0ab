"""NewsgroupsPipeline, AmazonReviewsPipeline and StupidBackoffPipeline, the
text loaders and the launcher: the port against the JAX package on the
CPU.

- The three apps at `tests/test_pipelines_e2e.py`'s sizes, fit by each
  package: the same accuracy, train error and F1, the same
  stupid-backoff vocabulary and trigram count, the mean log score within
  1e-12 (host arithmetic in both).
- JAX's fitted vocabulary and weights carried across by `convert.py`:
  the port's scores within 1e-6 of max|score| of JAX's (naive Bayes) and
  1e-5 (logistic regression), the same argmax and accuracy.
- The apps' own fits: Amazon's objective within 1e-4 relative of the
  objective of JAX's W (both evaluated in float64 from the CSR).

Run as a script, this file prints the JAX package's CPU values that
`chip_smoke.py` pins, at the script's sizes (`jax_reference_values`;
about 2 minutes and 10 GB of host memory at full size):

    JAX_PLATFORMS=cpu python tests/test_torch_text_pipelines.py
"""

import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keystone_tpu.data.dataset import HostDataset as JaxHostDataset
from keystone_tpu.evaluation import (
    BinaryClassifierEvaluator as JaxBinaryEvaluator,
    MulticlassClassifierEvaluator as JaxMulticlassEvaluator,
)
from keystone_tpu.loaders import text_loaders as jax_loaders
from keystone_tpu.nodes.learning.classifiers import (
    NaiveBayesEstimator as JaxNaiveBayes,
    _logreg_fit,
)
from keystone_tpu.nodes.nlp import (
    LowerCase as JaxLowerCase,
    NGramsFeaturizer as JaxNGrams,
    TermFrequency as JaxTermFrequency,
    Tokenizer as JaxTokenizer,
    Trim as JaxTrim,
)
from keystone_tpu.nodes.util import CommonSparseFeatures as JaxCommon
from keystone_tpu.pipelines import text_pipelines as jax_tp
from keystone_tpu_torch import __main__ as launcher
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import HostDataset
from keystone_tpu_torch.data.sparse import SparseDataset
from keystone_tpu_torch.loaders import text_loaders
from keystone_tpu_torch.pipelines import text_pipelines as tp
from keystone_tpu_torch.workflow.env import PipelineEnv, compute_prefix

REPO = pathlib.Path(__file__).resolve().parent.parent
NB_SCORE_REL = 1e-6
LR_SCORE_REL = 1e-5
LR_OBJECTIVE_REL = 1e-4
SB_TOL = 1e-12


def _jax_pairs():
    """JAX's text featurizer up to the (n-gram, √count) pairs
    (`text_pipelines.py:73-78`)."""
    return (JaxTrim().to_pipeline() >> JaxLowerCase() >> JaxTokenizer()
            >> JaxNGrams((1, 2)) >> JaxTermFrequency(math.sqrt))


def objective64(X, y, W, lam):
    """−Σ(logits·onehot − logsumexp)/n + ½λ‖W‖² in float64 from a CSR."""
    L = X.astype(np.float64) @ np.asarray(W, np.float64)
    m = L.max(1, keepdims=True)
    logz = (m + np.log(np.exp(L - m).sum(1, keepdims=True)))[:, 0]
    return float(-np.sum(L[np.arange(len(y)), y] - logz) / len(y)
                 + 0.5 * lam * np.sum(np.asarray(W, np.float64) ** 2))


def jax_newsgroups(n_train, n_test, num_classes):
    """The JAX package's Newsgroups fit on `synthetic_corpus(n_train,
    num_classes, seed=0)`, scored on `(n_test, seed=1)`: (vocabulary,
    naive Bayes (log_priors, log_cond), test scores, test accuracy)."""
    train_labels, train_docs = jax_tp.synthetic_corpus(n_train, num_classes,
                                                       seed=0)
    test_labels, test_docs = jax_tp.synthetic_corpus(n_test, num_classes,
                                                     seed=1)
    pairs = _jax_pairs()
    vec = JaxCommon(100_000).fit(pairs(train_docs).get())
    nb = JaxNaiveBayes(num_classes).fit(
        vec.apply_batch(pairs(train_docs).get()), train_labels.items)
    scores = nb.apply_batch(vec.apply_batch(pairs(test_docs).get()))
    scores = np.asarray(scores.array)[:len(test_docs)]
    acc = JaxMulticlassEvaluator(num_classes)(
        scores.argmax(1), np.asarray(test_labels.items)).accuracy
    return vec.vocab, (np.asarray(nb.log_priors), np.asarray(nb.log_cond)), \
        scores, acc


def jax_amazon(n_synth, lam=1e-3):
    """The JAX package's Amazon fit on `synthetic_corpus(n_synth, 2,
    seed=0)`, split 80/20 (`text_pipelines.py:164-196`), `_logreg_fit` on
    one device: a dict of the vocabulary, W, the objective of W in
    float64, the test scores, accuracy and F1."""
    labels, docs = jax_tp.synthetic_corpus(n_synth, 2, seed=0)
    n_train = int(0.8 * n_synth)
    train = JaxHostDataset(docs.items[:n_train])
    test = JaxHostDataset(docs.items[n_train:])
    y = np.asarray(labels.items[:n_train], np.int32)
    pairs = _jax_pairs()
    vec = JaxCommon(100_000).fit(pairs(train).get())
    X = vec.apply_batch(pairs(train).get()).matrix
    W = np.asarray(_logreg_fit(jnp.asarray(X.toarray()), jnp.asarray(y),
                               jnp.ones(n_train, jnp.float32),
                               jnp.float32(lam), 2, 50))
    scores = vec.apply_batch(pairs(test).get()).matrix @ W
    ev = JaxBinaryEvaluator()(scores.argmax(1).astype(bool),
                              np.asarray(labels.items[n_train:], bool))
    return {"vocab": vec.vocab, "W": W, "objective": objective64(X, y, W, lam),
            "scores": scores, "test_accuracy": ev.accuracy, "f1": ev.f1}


def jax_reference_values(news=(11_314, 7_532, 20), amazon=20_000,
                         backoff=11_314):
    """The values `chip_smoke.py` pins: JAX's Newsgroups test accuracy,
    Amazon's objective, accuracy and F1, and the stupid-backoff
    results."""
    _, _, _, news_acc = jax_newsgroups(*news)
    am = jax_amazon(amazon)
    sb = jax_tp.run_stupid_backoff(jax_tp.StupidBackoffConfig(n_synth=backoff))
    return {"newsgroups_test_accuracy": news_acc,
            "amazon_objective": am["objective"],
            "amazon_test_accuracy": am["test_accuracy"],
            "amazon_f1": am["f1"], "stupid_backoff": sb}


def test_synthetic_corpus_equals_jax():
    for n, k, seed in ((30, 4, 0), (17, 2, 5), (10, 20, 1)):
        labels, docs = tp.synthetic_corpus(n, k, seed=seed)
        jlabels, jdocs = jax_tp.synthetic_corpus(n, k, seed=seed)
        assert labels.items == jlabels.items and docs.items == jdocs.items


def test_newsgroups_app_equals_jax():
    cfg = dict(n_synth=200)
    got = tp.run_newsgroups(tp.NewsgroupsConfig(**cfg), "cpu")
    want = jax_tp.run_newsgroups(jax_tp.NewsgroupsConfig(**cfg))
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["train_error"] == want["train_error"]
    assert got["seconds"] > 0.0 and got["docs_per_sec"] > 0.0
    # the predictor builder alone gives the same classes
    labels, docs = tp.synthetic_corpus(200, 4, seed=0)
    docs = HostDataset(docs.items, device="cpu")
    pred = tp.build_newsgroups_predictor(docs, labels, 4)(docs).get()
    assert np.mean(pred.numpy() == np.asarray(labels.items)) \
        == 1.0 - want["train_error"]
    # the training documents' CSR is kept: the fit and the train predict
    # share it, and its device copy
    model = got["model"]
    kept = _cached(model.vectorizer, model.train_docs)
    assert isinstance(kept, SparseDataset) and kept._csr is not None


def _cached(pipeline, data):
    """The value that ``pipeline``'s final Cacher keeps for ``data``:
    the prefix table's entry for the Cacher's prefix."""
    applied = pipeline(data)
    graph = applied.graph
    prefix = compute_prefix(graph, graph.get_sink_dependency(applied.sink))
    return PipelineEnv.get().state[prefix].get


def test_amazon_app_equals_jax():
    cfg = dict(n_synth=200)
    got = tp.run_amazon(tp.AmazonReviewsConfig(**cfg), "cpu")
    want = jax_tp.run_amazon(jax_tp.AmazonReviewsConfig(**cfg))
    assert got["test_accuracy"] == want["test_accuracy"]
    assert got["f1"] == want["f1"]
    est = got["estimator"]
    assert len(est.loss_history) == 50 and min(est.linesearch_steps) >= 1


def test_amazon_objective_equals_jax():
    want = jax_amazon(300)
    labels, docs = tp.synthetic_corpus(300, 2, seed=0)
    got = tp.run_amazon_on(labels, docs, tp.AmazonReviewsConfig(), "cpu")
    model = got["model"]
    X = model.vectorizer(model.train_docs).get()
    y = np.asarray(labels.items[:240])
    W = model.classifier.fitted().W.numpy()
    assert abs(objective64(X.matrix, y, W, 1e-3) / want["objective"] - 1.0) \
        <= LR_OBJECTIVE_REL
    assert (got["test_accuracy"], got["f1"]) == (want["test_accuracy"],
                                                 want["f1"])


def test_stupid_backoff_app_equals_jax():
    for n in (50, 120):
        got = tp.run_stupid_backoff(tp.StupidBackoffConfig(n_synth=n), "cpu")
        want = jax_tp.run_stupid_backoff(jax_tp.StupidBackoffConfig(n_synth=n))
        assert got["vocab"] == want["vocab"]
        assert got["num_trigrams"] == want["num_trigrams"]
        assert abs(got["mean_log_score"] - want["mean_log_score"]) <= SB_TOL


def test_newsgroups_with_jax_weights_scores_as_jax():
    vocab, (log_priors, log_cond), want, acc = jax_newsgroups(240, 90, 4)
    test_labels, test_docs = tp.synthetic_corpus(90, 4, seed=1)
    docs = HostDataset(test_docs.items, device="cpu")
    scorer = convert.fitted_text_predictor(
        vocab, convert.naive_bayes_model(log_priors, log_cond, "cpu"))
    got = scorer(docs).get().numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=NB_SCORE_REL * np.abs(want).max())
    pred = convert.fitted_newsgroups_predictor(
        vocab, log_priors, log_cond, device="cpu")(docs).get().numpy()
    assert np.mean(pred == np.asarray(test_labels.items)) == acc
    # one document: the single-datum path gives its batch row's class
    one = convert.fitted_newsgroups_predictor(
        vocab, log_priors, log_cond, device="cpu")(test_docs.items[7]).get()
    assert int(one) == pred[7]


def test_amazon_with_jax_weights_scores_as_jax():
    want = jax_amazon(250)
    labels, docs = tp.synthetic_corpus(250, 2, seed=0)
    test = HostDataset(docs.items[200:], device="cpu")
    model = convert.logistic_regression_model(want["W"], "cpu")
    pred = convert.fitted_text_predictor(want["vocab"], model)(test).get()
    np.testing.assert_array_equal(pred.numpy(), want["scores"].argmax(1))
    X = (tp.text_featurizer() >> convert.sparse_vectorizer(want["vocab"]))(
        test).get()
    np.testing.assert_allclose(
        model.scores(X).numpy(), want["scores"], rtol=0,
        atol=LR_SCORE_REL * np.abs(want["scores"]).max())
    acc = np.mean(pred.numpy() == np.asarray(labels.items[200:]))
    assert acc == want["test_accuracy"]


def test_newsgroups_loader_equals_jax(tmp_path):
    for cls, files in (("sci.space", {"b.txt": "Orbit\tand\x0bmoon",
                                      "a.txt": "launch  pad\n"}),
                       ("alt.atheism", {"1": "god\r\nless"}),
                       ("comp.graphics", {})):
        (tmp_path / cls).mkdir()
        for name, text in files.items():
            (tmp_path / cls / name).write_text(text)
    (tmp_path / "README").write_text("not a class")
    got = text_loaders.newsgroups_loader(str(tmp_path))
    want = jax_loaders.newsgroups_loader(str(tmp_path))
    assert got.class_names == want.class_names == [
        "alt.atheism", "comp.graphics", "sci.space"]
    assert got.labels.items == want.labels.items == [0, 2, 2]
    assert got.data.items == want.data.items
    r = tp.run_newsgroups(tp.NewsgroupsConfig(train_path=str(tmp_path)),
                          "cpu")
    assert 0.0 <= r["test_accuracy"] <= 1.0


def test_amazon_loader_equals_jax(tmp_path):
    rows = [{"reviewText": "great", "overall": 5.0},
            {"reviewText": "meh", "overall": 3.5},
            {"overall": 4},
            {"reviewText": "bad", "overall": 1}]
    path = tmp_path / "reviews.json"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    got = text_loaders.amazon_reviews_loader(str(path))
    want = jax_loaders.amazon_reviews_loader(str(path))
    assert got.labels.items == want.labels.items == [1, 0, 1, 0]
    assert got.data.items == want.data.items == ["great", "meh", "", "bad"]
    assert got.class_names is None
    assert text_loaders.amazon_reviews_loader(
        str(path), threshold=4.5).labels.items == [1, 0, 0, 0]


@pytest.mark.parametrize("argv", [
    ["pipelines.text.NewsgroupsPipeline", "--nSynth", "120"],
    ["NewsgroupsPipeline", "--n-synth", "120", "--common-features", "500"],
    ["pipelines.text.AmazonReviewsPipeline", "--n-synth", "120"],
    ["AmazonReviewsPipeline", "--nSynth", "120", "--lam", "0.01"],
    ["pipelines.nlp.StupidBackoffPipeline", "--nSynth", "40"],
    ["StupidBackoffPipeline", "--n-synth", "40"],
])
def test_launcher_runs_the_text_pipelines_on_the_cpu(argv):
    assert launcher.main(argv + ["--device", "cpu"]) == 0


def test_launcher_as_a_module_runs_newsgroups():
    out = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "NewsgroupsPipeline",
         "--n-synth", "80", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "test_error=" in out.stdout


def test_text_entry_points_raise_without_a_card():
    """Left at ``device="cuda"``, each new entry point raises with no
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    labels, docs = tp.synthetic_corpus(20, 2, seed=0)
    calls = [
        lambda: tp.run_newsgroups(tp.NewsgroupsConfig(n_synth=20)),
        lambda: tp.run_newsgroups_on(labels, docs, labels, docs, 2,
                                     tp.NewsgroupsConfig()),
        lambda: tp.run_amazon(tp.AmazonReviewsConfig(n_synth=20)),
        lambda: tp.run_amazon_on(labels, docs, tp.AmazonReviewsConfig()),
        lambda: tp.run_stupid_backoff(tp.StupidBackoffConfig(n_synth=20)),
        lambda: tp.main(["newsgroups", "--n-synth", "20"]),
        lambda: tp.main(["amazon", "--n-synth", "20"]),
        lambda: tp.main(["stupid-backoff", "--n-synth", "20"]),
        lambda: convert.naive_bayes_model(np.zeros(2), np.zeros((2, 3))),
        lambda: convert.logistic_regression_model(np.zeros((3, 2))),
        lambda: SparseDataset(np.eye(2, dtype=np.float32)).csr(),
        lambda: SparseDataset(np.eye(2, dtype=np.float32)).densify(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


if __name__ == "__main__":
    print(json.dumps(jax_reference_values()))
