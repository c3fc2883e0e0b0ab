"""The text pipelines on one CUDA card.

Counterpart of `keystone_tpu/pipelines/text_pipelines.py` (`:46-233`)
and its apps' flags (`pipelines/cli_mains.py:113-160`):

- NewsgroupsPipeline (reference pipelines/text/NewsgroupsPipeline.scala):
  Trim → LowerCase → Tokenizer → n-grams (orders 1–2) → √TF →
  CommonSparseFeatures(100,000) → naive Bayes (λ 1) → MaxClassifier.
- AmazonReviewsPipeline (AmazonReviewsPipeline.scala): the same
  featurizer → logistic regression over 2 classes (λ 1e-3, 50 L-BFGS
  steps), on an 80/20 split.
- StupidBackoffPipeline (StupidBackoffPipeline.scala): WordFrequencyEncoder
  → trigrams → counts → stupid-backoff scores.

The string stages run on the host, as in JAX (`nodes/nlp/text.py`), and
end in a host CSR; its arrays go to the card once and the classifiers'
products run on the CSR there (`nodes/learning/classifiers.py`). Two
`Cacher`s keep the training documents' (feature, value) pairs and their
CSR, so the vocabulary fit, the classifier's fit and the train predict
featurize the training documents once and copy their CSR once. The
stupid-backoff model is host numpy in both packages: nothing of it runs
on a device.

Data: a real corpus (``--train-path``/``--data-path``, through
`loaders/text_loaders.py`), or `synthetic_corpus`, a numpy-identical copy
of the JAX package's class-conditional stand-in. `run_newsgroups` caps a
synthetic run at 4 classes (`:125`); `run_newsgroups_on` and
`run_amazon_on` take a corpus as given.

Each ``run_*`` takes ``mesh=``, as `imagenet_sift_lcs_fv.run_on` does
(`run_*` default to the current mesh: none in one process). Every rank
passes all the documents and `HostDataset.on_mesh` keeps its share; the
string stages and the CSR are this rank's rows, the vocabularies and the
fits merge or reduce over the ranks, the predictions keep the rows'
placement and the evaluators count every rank's. Amazon's 80/20 split
is taken on the whole list before placing. The clocks are JAX's.

    python -m keystone_tpu_torch.pipelines.text_pipelines newsgroups \\
        --device cpu --n-synth 400
    python -m keystone_tpu_torch.pipelines.text_pipelines amazon --n-synth 400
    python -m keystone_tpu_torch.pipelines.text_pipelines stupid-backoff
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..data.dataset import Dataset, HostDataset
from ..device import DeviceLike, resolve_device
from ..evaluation import (
    BinaryClassifierEvaluator,
    MulticlassClassifierEvaluator,
)
from ..loaders.text_loaders import amazon_reviews_loader, newsgroups_loader
from ..parallel.mesh import DATA_AXIS, axis_size, current_mesh
from ..nodes.learning.classifiers import (
    LogisticRegressionEstimator,
    NaiveBayesEstimator,
)
from ..nodes.nlp import (
    LowerCase,
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    TermFrequency,
    Tokenizer,
    Trim,
    WordFrequencyEncoder,
)
from ..nodes.util.basic import Cacher, MaxClassifier
from ..nodes.util.sparse_features import CommonSparseFeatures
from ..workflow.pipeline import Pipeline
from .random_patch_cifar import _sync

#: classes of a synthetic Newsgroups run (`:125`)
SYNTH_MAX_CLASSES = 4


def synthetic_corpus(n_docs: int, num_classes: int, vocab_size: int = 400,
                     doc_len: int = 60, seed: int = 0):
    """(labels, documents) as host datasets: each class prefers a slice
    of the ``vocab_size`` words, so the classes separate. The numpy draws
    and strings of the JAX package's `synthetic_corpus` (`:46-62`)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    labels, docs = [], []
    per = vocab_size // num_classes
    for _ in range(n_docs):
        c = int(rng.integers(num_classes))
        base = rng.integers(0, vocab_size, size=doc_len // 2)
        pref = c * per + rng.integers(0, per, size=doc_len - doc_len // 2)
        idx = np.concatenate([base, pref])
        rng.shuffle(idx)
        docs.append(" ".join(words[j] for j in idx))
        labels.append(c)
    return HostDataset(labels), HostDataset(docs)


def text_featurizer(ngram_orders=(1, 2)) -> Pipeline:
    """Trim → LowerCase → Tokenizer → n-grams → √TF, cached: each item's
    (n-gram, √count) pairs."""
    return (Trim().to_pipeline() >> LowerCase() >> Tokenizer()
            >> NGramsFeaturizer(ngram_orders) >> TermFrequency(math.sqrt)
            >> Cacher("text-features"))


@dataclass
class TextModel:
    """A text classifier's parts: ``featurizer`` (documents → pairs,
    cached), ``vocabulary`` (the featurizer and the lazily fit
    vocabulary: its `fitted()` is the vectorizer the vocabulary fit
    gives), ``vectorizer`` (documents → a `SparseDataset`, cached),
    ``classifier`` (the vectorizer and the lazily fit classifier: its
    `fitted()` is the model), ``predictor`` (documents → class ids) and
    ``train_docs``, the documents both fits train on."""

    featurizer: Pipeline
    vocabulary: Pipeline
    vectorizer: Pipeline
    classifier: Pipeline
    predictor: Pipeline
    train_docs: object


def build_text_model(train_docs, train_labels, estimator,
                     ngram_orders=(1, 2),
                     common_features: int = 100_000) -> TextModel:
    """The featurizer with its vocabulary fit on ``train_docs``, then
    ``estimator`` fit on their CSR and ``train_labels``; nothing is fit
    until it runs. A naive Bayes model's scores go through
    `MaxClassifier`; a logistic regression model gives class ids."""
    featurizer = text_featurizer(ngram_orders)
    vocabulary = featurizer.and_then(CommonSparseFeatures(common_features),
                                     train_docs)
    vectorizer = vocabulary >> Cacher("text-csr")
    classified = vectorizer.and_then(estimator, train_docs, train_labels)
    predictor = classified >> MaxClassifier() if isinstance(
        estimator, NaiveBayesEstimator) else classified
    return TextModel(featurizer, vocabulary, vectorizer, classified,
                     predictor, train_docs)


def build_newsgroups_predictor(train_docs, train_labels, num_classes: int,
                               ngram_orders=(1, 2),
                               common_features: int = 100_000) -> Pipeline:
    """The Newsgroups pipeline (`:65-82`): documents → class ids."""
    return build_text_model(train_docs, train_labels,
                            NaiveBayesEstimator(num_classes), ngram_orders,
                            common_features).predictor


def analyzable(config: Optional["NewsgroupsConfig"] = None,
               device: DeviceLike = "cuda"):
    """The Newsgroups predictor over abstract placeholder data, for static
    validation (`keystone_tpu/pipelines/text_pipelines.py:65-103`): the
    JAX package's graph (the featurizer and the naive Bayes fit without
    this module's two `Cacher`s). The NLP stages are host code, so their
    specs are UNKNOWN. It holds no weights before its fit, so ``device``
    is unused. Returns ``(pipeline, source_spec)``."""
    from ..analysis import SpecDataset

    config = config or NewsgroupsConfig()
    n = 128
    num_classes = min(config.num_classes, 4)
    docs = SpecDataset(count=n, name="newsgroups-docs", on_device=False)
    labels = SpecDataset((), np.int32, count=n, name="newsgroups-labels",
                         on_device=False)
    feats = (Trim().to_pipeline() >> LowerCase() >> Tokenizer()
             >> NGramsFeaturizer(config.ngram_orders)
             >> TermFrequency(math.sqrt)).and_then(
        CommonSparseFeatures(config.common_features), docs)
    predictor = feats.and_then(NaiveBayesEstimator(num_classes), docs,
                               labels) >> MaxClassifier()
    return predictor, None


@dataclass
class NewsgroupsConfig:
    train_path: Optional[str] = None
    test_path: Optional[str] = None
    ngram_orders: tuple = (1, 2)
    common_features: int = 100_000
    num_classes: int = 20
    n_synth: int = 400
    seed: int = 0


def _actuals(labels: HostDataset, docs: HostDataset, device):
    """Class ids to score ``docs``' predictions against: the list, or on
    a mesh a `Dataset` placed as ``docs`` (every rank passes them
    all)."""
    if docs.mesh is None:
        return labels.items
    return Dataset(np.asarray(labels.items, np.int32), device=device,
                   mesh=docs.mesh)


def run_newsgroups_on(train_labels: HostDataset, train_docs: HostDataset,
                      test_labels: HostDataset, test_docs: HostDataset,
                      num_classes: int, config: NewsgroupsConfig,
                      device: DeviceLike = "cuda", mesh=None) -> dict:
    """Build the Newsgroups predictor on ``device`` and score the train
    and test documents. ``seconds`` runs from after the build to the test
    evaluation, the lazy fits included, as the JAX package's clock
    (`:138-148`). ``predictions`` are the test documents' classes (this
    rank's on ``mesh``, where every rank passes every document and label
    and keeps its share)."""
    dev = resolve_device(device)
    train_docs = HostDataset.on_mesh(train_docs.items, mesh, device=dev)
    test_docs = HostDataset.on_mesh(test_docs.items, mesh, device=dev)
    train_actuals = _actuals(train_labels, train_docs, dev)
    test_actuals = _actuals(test_labels, test_docs, dev)
    model = build_text_model(
        train_docs, HostDataset.on_mesh(train_labels.items, mesh),
        NaiveBayesEstimator(num_classes), config.ngram_orders,
        config.common_features)
    _sync(dev)
    t0 = time.perf_counter()
    evaluator = MulticlassClassifierEvaluator(num_classes)
    train_eval = evaluator(model.predictor(train_docs), train_actuals)
    predictions = model.predictor(test_docs).get()
    test_eval = evaluator(predictions, test_actuals)
    elapsed = time.perf_counter() - t0
    return {
        "train_error": train_eval.error,
        "test_error": test_eval.error,
        "test_accuracy": test_eval.accuracy,
        "seconds": elapsed,
        "docs_per_sec": (train_docs.total + test_docs.total) / elapsed,
        "summary": test_eval.summary(),
        "predictions": predictions,
        "model": model,
    }


def run_newsgroups(config: NewsgroupsConfig, device: DeviceLike = "cuda",
                   mesh=None) -> dict:
    """The corpus under ``train_path`` (and ``test_path``), or the
    synthetic one at ``n_synth`` and ``n_synth // 4`` documents of at
    most `SYNTH_MAX_CLASSES` classes (`:118-135`); on ``mesh`` (default
    the current one) each rank keeps its share (`run_newsgroups_on`)."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else current_mesh()
    if config.train_path:
        train = newsgroups_loader(config.train_path)
        test = newsgroups_loader(config.test_path or config.train_path)
        return run_newsgroups_on(train.labels, train.data, test.labels,
                                 test.data, len(train.class_names), config,
                                 device, mesh)
    num_classes = min(config.num_classes, SYNTH_MAX_CLASSES)
    train_labels, train_docs = synthetic_corpus(config.n_synth, num_classes,
                                                seed=config.seed)
    test_labels, test_docs = synthetic_corpus(config.n_synth // 4,
                                              num_classes,
                                              seed=config.seed + 1)
    return run_newsgroups_on(train_labels, train_docs, test_labels,
                             test_docs, num_classes, config, device, mesh)


@dataclass
class AmazonReviewsConfig:
    data_path: Optional[str] = None
    ngram_orders: tuple = (1, 2)
    common_features: int = 100_000
    lam: float = 1e-3
    n_synth: int = 400
    seed: int = 0


def run_amazon_on(labels: HostDataset, docs: HostDataset,
                  config: AmazonReviewsConfig,
                  device: DeviceLike = "cuda", mesh=None) -> dict:
    """Split the reviews 80/20 in order (`:166-173`), fit logistic
    regression on the first part on ``device`` and score the rest.
    ``seconds`` runs from after the build to the test evaluation, the
    lazy fits included (`:187-196`). ``predictions`` are the test
    reviews' classes. On ``mesh`` every rank passes every review: the
    split is taken on the whole list, then each part placed."""
    dev = resolve_device(device)
    n_train = int(0.8 * len(docs))
    train_docs = HostDataset.on_mesh(docs.items[:n_train], mesh, device=dev)
    test_docs = HostDataset.on_mesh(docs.items[n_train:], mesh, device=dev)
    train_labels = Dataset(np.asarray(labels.items[:n_train], np.int32),
                           device=dev, mesh=train_docs.mesh)
    test_labels = np.asarray(labels.items[n_train:], bool)
    estimator = LogisticRegressionEstimator(2, lam=config.lam)
    model = build_text_model(train_docs, train_labels, estimator,
                             config.ngram_orders, config.common_features)
    _sync(dev)
    t0 = time.perf_counter()
    predictions = model.predictor(test_docs).get()
    test_eval = BinaryClassifierEvaluator()(predictions, test_labels)
    elapsed = time.perf_counter() - t0
    return {
        "test_accuracy": test_eval.accuracy,
        "f1": test_eval.f1,
        "seconds": elapsed,
        "docs_per_sec": len(docs) / elapsed,
        "predictions": predictions,
        "model": model,
        "estimator": estimator,
    }


def run_amazon(config: AmazonReviewsConfig, device: DeviceLike = "cuda",
               mesh=None) -> dict:
    """The reviews under ``data_path``, or ``n_synth`` synthetic
    two-class documents; on ``mesh`` (default the current one) each rank
    keeps its share (`run_amazon_on`)."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else current_mesh()
    if config.data_path:
        data = amazon_reviews_loader(config.data_path)
        labels, docs = data.labels, data.data
    else:
        labels, docs = synthetic_corpus(config.n_synth, 2, seed=config.seed)
    return run_amazon_on(labels, docs, config, device, mesh)


@dataclass
class StupidBackoffConfig:
    data_path: Optional[str] = None
    n_synth: int = 200
    seed: int = 0


def run_stupid_backoff_on(docs: HostDataset, mesh=None) -> dict:
    """Trigram counts of ``docs`` and stupid-backoff scores of the first
    100 trigrams of the first 50 documents: their mean log score, the
    vocabulary and the distinct trigrams (`:207-233`). Host numpy. On
    ``mesh`` every rank passes every document and counts its share; the
    counts are merged by the fits and the first 50 documents' trigrams
    gathered, so every rank scores as one process."""
    t0 = time.perf_counter()
    docs = HostDataset.on_mesh(docs.items, mesh)
    tokens = (Trim().to_pipeline() >> LowerCase() >> Tokenizer())(docs).get()
    encoder = WordFrequencyEncoder().fit(tokens)
    trigrams = NGramsFeaturizer([3]).apply_batch(tokens)
    counted = NGramsCounts("default").apply_batch(trigrams)
    # one item a rank, this rank's counts: every rank passes as many
    # items as the data axis has ranks and keeps its own
    model = StupidBackoffEstimator(encoder.word_counts).fit(
        HostDataset.on_mesh([dict(counted.items[0])]
                            * axis_size(docs.mesh, DATA_AXIS), docs.mesh))
    scores = []
    for ngrams in trigrams.take(50):
        for ng in ngrams[:100]:
            s = model.score(ng)
            if s > 0:
                scores.append(np.log(s))
    return {
        "mean_log_score": float(np.mean(scores)) if scores else float("-inf"),
        "vocab": len(encoder.vocab),
        "num_trigrams": len(model.ngram_counts),
        "seconds": time.perf_counter() - t0,
    }


def run_stupid_backoff(config: StupidBackoffConfig,
                       device: DeviceLike = "cuda", mesh=None) -> dict:
    """The lines of ``data_path``, or ``n_synth`` synthetic documents.
    The pipeline is host code in both packages; ``device`` is only
    checked, as every entry point's is. On ``mesh`` (default the current
    one) each rank counts its share (`run_stupid_backoff_on`)."""
    resolve_device(device)
    mesh = mesh if mesh is not None else current_mesh()
    if config.data_path:
        with open(config.data_path) as f:
            docs = HostDataset([line.strip() for line in f if line.strip()])
    else:
        _, docs = synthetic_corpus(config.n_synth, 2, seed=config.seed)
    return run_stupid_backoff_on(docs, mesh)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    apps = p.add_subparsers(dest="app", required=True)
    news = apps.add_parser("newsgroups", help="NewsgroupsPipeline")
    news.add_argument("--train-path")
    news.add_argument("--test-path")
    news.add_argument("--common-features", type=int)
    news.add_argument("--n-synth", type=int)
    amazon = apps.add_parser("amazon", help="AmazonReviewsPipeline")
    amazon.add_argument("--data-path")
    amazon.add_argument("--common-features", type=int)
    amazon.add_argument("--lam", type=float)
    amazon.add_argument("--n-synth", type=int)
    backoff = apps.add_parser("stupid-backoff", help="StupidBackoffPipeline")
    backoff.add_argument("--data-path")
    backoff.add_argument("--n-synth", type=int)
    for sub in (news, amazon, backoff):
        sub.add_argument("--device", default="cuda",
                         help="torch device to run on (default: cuda)")
    args = vars(p.parse_args(argv))
    app, device = args.pop("app"), args.pop("device")
    given = {k: v for k, v in args.items() if v is not None}
    if app == "newsgroups":
        r = run_newsgroups(NewsgroupsConfig(**given), device)
        print(r["summary"])
        print(f"test_error={r['test_error']:.4f} time={r['seconds']:.1f}s")
    elif app == "amazon":
        r = run_amazon(AmazonReviewsConfig(**given), device)
        print(f"accuracy={r['test_accuracy']:.4f} f1={r['f1']:.4f} "
              f"time={r['seconds']:.1f}s")
    else:
        r = run_stupid_backoff(StupidBackoffConfig(**given), device)
        print(f"mean_log_score={r['mean_log_score']:.4f} vocab={r['vocab']} "
              f"trigrams={r['num_trigrams']}")
    return r


if __name__ == "__main__":
    main()
