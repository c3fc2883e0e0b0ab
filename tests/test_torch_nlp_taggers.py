"""The port's POS/NER side against the JAX package's, on the CPU.

`keystone_tpu_torch/nodes/nlp/{synthetic_corpus,perceptron_tagger,
annotators}.py` and the bundled corpora under `nlp/data/` against their
JAX twins: the generated corpora token for token, the data files byte for
byte, the perceptron taggers' weights, tags and saved JSON (files cross
between the packages both ways), and the annotators' heuristic tags,
lemmas and n-grams. Mirrors `tests/test_perceptron_tagger.py` and the
annotator cases of `tests/test_runtime_extras.py` and
`tests/test_reference_density.py`.
"""

import json
import os

import numpy as np
import pytest

from keystone_tpu.nodes.nlp import annotators as jann
from keystone_tpu.nodes.nlp import perceptron_tagger as jpt
from keystone_tpu.nodes.nlp import synthetic_corpus as jsc
from keystone_tpu_torch.convert import perceptron_from_jax
from keystone_tpu_torch.nodes.nlp import NER, CoreNLPFeatureExtractor, POSTagger
from keystone_tpu_torch.nodes.nlp import annotators as ann
from keystone_tpu_torch.nodes.nlp import perceptron_tagger as pt
from keystone_tpu_torch.nodes.nlp import synthetic_corpus as sc
from keystone_tpu_torch.nodes.nlp.annotators import _DATA_DIR, _lemma
from keystone_tpu_torch.nodes.nlp.perceptron_tagger import (
    AveragedPerceptronTagger,
    StructuredPerceptronTagger,
    load_tagged_corpus,
)

CORPORA = ("pos_corpus.txt", "ner_corpus.txt")
LEMMA_GOLD = os.path.join(os.path.dirname(__file__), "resources",
                          "lemma_gold.tsv")


def _split(corpus):
    sentences = load_tagged_corpus(os.path.join(_DATA_DIR, corpus))
    rng = np.random.default_rng(0)
    order = rng.permutation(len(sentences))
    cut = int(len(sentences) * 0.8)
    return ([sentences[i] for i in order[:cut]],
            [sentences[i] for i in order[cut:]])


def _held_out_accuracy(corpus, cls=AveragedPerceptronTagger):
    train, test = _split(corpus)
    tagger = cls().train(train)
    correct = total = 0
    for sent in test:
        pred = tagger([w for w, _ in sent])
        for p, (_, gold) in zip(pred, sent):
            correct += p == gold
            total += 1
    return correct / total


# ----------------------------------------------------------------- corpora


@pytest.mark.parametrize("gen,n,seed", [
    ("generate_pos_corpus", 50, 0), ("generate_pos_corpus", 300, 3),
    ("generate_pos_corpus", 1000, 11), ("generate_ner_corpus", 100, 0),
    ("generate_ner_corpus", 400, 7), ("generate_ner_corpus", 1000, 1)])
def test_corpora_equal_jax(gen, n, seed):
    assert getattr(sc, gen)(n, seed) == getattr(jsc, gen)(n, seed)


def test_corpus_sizes_at_the_crf_defaults():
    pos = sc.generate_pos_corpus(4000, 0)
    ner = sc.generate_ner_corpus(4000, 0)
    assert sum(len(s) for s in pos) == 43_386
    assert len({t for s in pos for _, t in s}) == 15
    assert max(len(s) for s in pos) == 28
    assert len({t for s in ner for _, t in s}) == 6
    assert max(len(s) for s in ner) == 14
    assert pos == jsc.generate_pos_corpus(4000, 0)
    assert ner == jsc.generate_ner_corpus(4000, 0)


@pytest.mark.parametrize("name", CORPORA)
def test_bundled_corpora_are_byte_equal_copies(name):
    with open(os.path.join(_DATA_DIR, name), "rb") as f:
        got = f.read()
    with open(os.path.join(jann._DATA_DIR, name), "rb") as f:
        want = f.read()
    assert got == want and _DATA_DIR != jann._DATA_DIR
    path = os.path.join(_DATA_DIR, name)
    assert load_tagged_corpus(path) == jpt.load_tagged_corpus(path)


# ------------------------------------------------------------- perceptrons


@pytest.mark.parametrize("corpus", CORPORA)
def test_averaged_perceptron_equals_jax(corpus, tmp_path):
    train, test = _split(corpus)
    got = AveragedPerceptronTagger().train(train, n_iter=4, seed=1)
    want = jpt.AveragedPerceptronTagger().train(train, n_iter=4, seed=1)
    assert got.tags == want.tags and got.weights == want.weights
    for sent in test:
        tokens = [w for w, _ in sent]
        assert got(tokens) == want(tokens)
    # saved JSON: the same text; each package loads the other's
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got.save(a)
    want.save(b)
    assert open(a).read() == open(b).read()
    tokens = [w for w, _ in test[0]]
    assert jpt.AveragedPerceptronTagger.load(a)(tokens) == want(tokens)
    assert AveragedPerceptronTagger.load(b)(tokens) == got(tokens)


@pytest.mark.parametrize("corpus", CORPORA)
def test_structured_perceptron_equals_jax(corpus, tmp_path):
    train, test = _split(corpus)
    got = StructuredPerceptronTagger().train(train, n_iter=3, seed=2)
    want = jpt.StructuredPerceptronTagger().train(train, n_iter=3, seed=2)
    assert got.tags == want.tags
    assert got.weights == want.weights and got.trans == want.trans
    for sent in test:
        tokens = [w for w, _ in sent]
        assert got(tokens) == want(tokens)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got.save(a)
    want.save(b)
    assert json.load(open(a)) == json.load(open(b))
    assert open(a).read() == open(b).read()
    tokens = [w for w, _ in test[0]]
    assert jpt.StructuredPerceptronTagger.load(a)(tokens) == want(tokens)
    assert StructuredPerceptronTagger.load(b)(tokens) == got(tokens)


def test_perceptron_from_jax_tags_as_jax():
    train, test = _split("pos_corpus.txt")
    structured = jpt.StructuredPerceptronTagger().train(train, n_iter=2)
    greedy = jpt.AveragedPerceptronTagger().train(train, n_iter=2)
    port_s = perceptron_from_jax(structured.tags, structured.weights,
                                 structured.trans)
    port_g = perceptron_from_jax(greedy.tags, greedy.weights)
    assert isinstance(port_s, StructuredPerceptronTagger)
    assert isinstance(port_g, AveragedPerceptronTagger)
    for sent in test:
        tokens = [w for w, _ in sent]
        assert port_s(tokens) == structured(tokens)
        assert port_g(tokens) == greedy(tokens)


@pytest.mark.parametrize("word", ["Apple", "IBM", "x-ray", "3.5", "co-op's",
                                  "", "Ünïcode", "ab12CD"])
def test_feature_templates_equal_jax(word):
    assert pt._shape(word) == jpt._shape(word)
    tokens = ["The", word or "w", "1,000", "."]
    for i in range(len(tokens)):
        assert pt._features(tokens, i, "DT", "<s>") == \
            jpt._features(tokens, i, "DT", "<s>")
        assert pt._emission_features(tokens, i) == \
            jpt._emission_features(tokens, i)


def test_pos_held_out_accuracy():
    assert _held_out_accuracy("pos_corpus.txt") >= 0.90


def test_ner_held_out_accuracy():
    assert _held_out_accuracy("ner_corpus.txt") >= 0.90


def test_structured_beats_greedy_on_both_corpora():
    for corpus in CORPORA:
        greedy = _held_out_accuracy(corpus, AveragedPerceptronTagger)
        struct = _held_out_accuracy(corpus, StructuredPerceptronTagger)
        assert struct > greedy, (corpus, struct, greedy)
        assert struct >= 0.95, (corpus, struct)


def test_structured_empty_and_single_token():
    train, _ = _split("pos_corpus.txt")
    tagger = StructuredPerceptronTagger().train(train, n_iter=2)
    assert tagger([]) == []
    assert len(tagger(["dog"])) == 1


def test_viterbi_uses_transitions():
    sents = [[("p", "P"), ("x", "A")], [("q", "Q"), ("x", "B")]] * 6
    tagger = StructuredPerceptronTagger().train(sents, n_iter=6)
    assert tagger(["p", "x"]) == ["P", "A"]
    assert tagger(["q", "x"]) == ["Q", "B"]


# -------------------------------------------------------------- annotators


def test_trained_taggers_tag_as_jax():
    sentence = ["The", "farmer", "repairs", "the", "old", "cart", "."]
    tags = [t for _, t in POSTagger.trained().apply(sentence)]
    assert tags == ["DT", "NN", "VBZ", "DT", "JJ", "NN", "."]
    assert POSTagger.trained().apply(sentence) == \
        jann.POSTagger.trained().apply(sentence)
    sentence = ["Emma", "visited", "Berlin", "with", "Thomas", "."]
    tagged = NER.trained().apply(sentence)
    assert tagged == jann.NER.trained().apply(sentence)
    tags = dict(tagged)
    assert tags["Emma"] == "PER" and tags["Berlin"] == "LOC"
    assert tags["Thomas"] == "PER" and tags["visited"] == "O"


def test_bundled_tagger_cached_per_corpus():
    assert ann.bundled_tagger("pos_corpus.txt") is \
        ann.bundled_tagger("pos_corpus.txt")
    assert ann.bundled_tagger("pos_corpus.txt") is not \
        ann.bundled_tagger("ner_corpus.txt")
    assert isinstance(ann.bundled_tagger("pos_corpus.txt"),
                      StructuredPerceptronTagger)


def test_model_hook_accepts_a_callable():
    tagger = POSTagger(model=lambda toks: ["X"] * len(toks))
    assert tagger.apply(["a", "b"]) == [("a", "X"), ("b", "X")]


@pytest.mark.parametrize("tokens", [
    ["the", "cats", "ran", "quickly"], ["Today", "Alice", "visited", "NASA"],
    ["-3.5", "1,000", "+7", "famous", "walked", "hopeful", "realize",
     "things", "bus", "I", "and", "were"],
    ["A", "B", "USA", "Ab", "aB", "12abc"]])
def test_heuristic_taggers_equal_jax(tokens):
    assert ann._heuristic_pos(tokens) == jann._heuristic_pos(tokens)
    assert ann._heuristic_ner(tokens) == jann._heuristic_ner(tokens)


def test_annotators():
    pos = POSTagger().apply(["the", "cats", "ran", "quickly"])
    assert pos[0][1] == "DT" and pos[3][1] == "RB"
    ner = NER().apply(["Today", "Alice", "visited", "NASA"])
    assert ner[1][1] == "ENTITY" and ner[3][1] == "ENTITY"
    feats = CoreNLPFeatureExtractor([1]).apply("yesterday Alice was running")
    assert ("ENTITY",) in feats and ("run",) in feats


def test_lemmatizer_tables_equal_jax():
    assert ann._LEMMA_EXCEPTIONS == jann._LEMMA_EXCEPTIONS
    assert ann._NO_E_STEMS == jann._NO_E_STEMS
    assert ann._KEEP_DOUBLE == jann._KEEP_DOUBLE


def test_lemma_equals_jax_on_every_exception_and_rule_case():
    words = list(jann._LEMMA_EXCEPTIONS)
    words += [w.upper() for w in words[:20]]
    words += [line.split("\t")[0] for line in
              open(LEMMA_GOLD).read().strip().split("\n")]
    # each rule and guard: -ies, -zes, -ches/-shes/-xes/-sses, -s (and
    # its -ss/-us/-is guards), -ing/-ed with doubled, kept-double, -i,
    # and every silent-e branch; short words under the length guards
    stems = sorted(jann._NO_E_STEMS | jann._KEEP_DOUBLE)
    words += [s + suf for s in stems for suf in ("ing", "ed", "s")]
    words += ["studies", "sizes", "boxes", "wishes", "glasses", "cats",
              "bus", "axis", "ties", "zes", "running", "stopped", "telling",
              "studied", "making", "believed", "sized", "waltzed",
              "danced", "forced", "charged", "judged", "visited", "hoped",
              "played", "fixed", "ing", "red", "sing", "quickly", "a", "",
              "Went", "THE"]
    for w in words:
        assert _lemma(w) == jann._lemma(w), w
        assert ann._restore_e(w) == jann._restore_e(w), w


def test_lemmatizer_gold_fidelity():
    pairs = [line.split("\t") for line in
             open(LEMMA_GOLD).read().strip().split("\n")]
    assert len(pairs) >= 480
    misses = [(w, g.strip(), _lemma(w)) for w, g in pairs
              if _lemma(w) != g.strip()]
    assert (len(pairs) - len(misses)) / len(pairs) >= 0.97, misses[:20]


@pytest.mark.parametrize("text,orders", [
    ("yesterday Alice was running", (1,)),
    ("John visited Paris yesterday", (1, 2)),
    ("The ANALYSTS in Springfield expected 500 million\tdollars", (1, 2, 3)),
    ("", (1,))])
def test_corenlp_extractor_equals_jax(text, orders):
    got = CoreNLPFeatureExtractor(orders).apply(text)
    want = jann.CoreNLPFeatureExtractor(orders).apply(text)
    assert got == want
    got = CoreNLPFeatureExtractor(orders, ner=NER.trained()).apply(text)
    want = jann.CoreNLPFeatureExtractor(
        orders, ner=jann.NER.trained()).apply(text)
    assert got == want


def test_corenlp_extractor_with_trained_ner_replaces_entities():
    ex = CoreNLPFeatureExtractor(orders=(1,), ner=NER.trained())
    toks = [g[0] for g in ex.apply("John visited Paris yesterday")]
    assert "visit" in toks or "visited" in toks
    assert any(t.isupper() for t in toks), toks


def test_annotators_over_a_host_dataset():
    """As pipeline stages: the batch path maps each item over a
    `HostDataset` on the host."""
    from keystone_tpu_torch.data.dataset import HostDataset

    texts = ["John visited Paris yesterday", "the plan was approved"]
    data = HostDataset(texts, device="cpu")
    ex = CoreNLPFeatureExtractor((1, 2), ner=NER.trained())
    assert list(ex.apply_batch(data)) == [ex.apply(t) for t in texts]
    pipeline = ex.to_pipeline()
    assert list(pipeline(data).get()) == [ex.apply(t) for t in texts]


@pytest.mark.parametrize("name", ["POSTagger", "NER",
                                  "CoreNLPFeatureExtractor"])
def test_annotators_join_the_registry_and_audit_as_jax(name):
    from keystone_tpu.analysis.contracts import audit_class as jax_audit
    from keystone_tpu.analysis.contracts import (
        operator_registry as jax_registry,
    )
    from keystone_tpu_torch.analysis.contracts import (
        audit_class,
        operator_registry,
    )

    port = {c.__qualname__: c for c in operator_registry()}[name]
    want = {c.__qualname__: c for c in jax_registry()}[name]
    assert port.__module__ == "keystone_tpu_torch.nodes.nlp.annotators"
    got, got_probed = audit_class(port)
    exp, exp_probed = jax_audit(want)
    assert sorted(d.rule for d in got) == sorted(d.rule for d in exp)
    assert got_probed == exp_probed
