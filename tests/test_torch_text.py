"""The text nodes, the sparse vocabularies and the CSR dataset: the port
against the JAX package on the CPU.

Every node here is host Python in both packages, so every output must be
equal to JAX's: tokens, n-grams, counts, vocabularies, and the CSR's
``indptr``, ``indices`` and ``data`` arrays. The JAX tokenizer's default
pattern goes through its native scanner (`native/keystone_io.cpp`) when
the library loads, and through `str.split()` when it does not; the two
disagree on whitespace other than space, tab, newline and carriage
return. The port copies the native behaviour, so the tests assert that
the library loaded before they compare.
"""

import math
from collections import Counter

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from keystone_tpu.data.dataset import HostDataset as JaxHostDataset
from keystone_tpu.data.sparse import SparseDataset as JaxSparseDataset
from keystone_tpu.nodes import nlp as jax_nlp
from keystone_tpu.nodes.util import basic as jax_basic
from keystone_tpu.nodes.util import sparse_features as jax_sf
from keystone_tpu.utils import native_io
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.data.sparse import SparseDataset
from keystone_tpu_torch.nodes import nlp
from keystone_tpu_torch.nodes.util import basic
from keystone_tpu_torch.nodes.util import sparse_features as sf
from keystone_tpu_torch.workflow.pipeline import ItemTransformer

ODD_STRINGS = [
    "a\x0bb c\x0cd e\xa0f  g\th",
    "  Leading and trailing\r\n",
    "line one\r\nline two\n\nline   three",
    " em space\x1cfile\x1dgroup\x85next　ideo",
    "",
    " \t\r\n ",
    "tab\t\tthen  two\x0b\x0bverticals",
    "lone \ud800 surrogate",
    "MiXeD CaSe ÀÉÎ ß",
]


def _docs(n, vocab, length, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{j}" for j in rng.integers(0, vocab, length))
            for _ in range(n)]


@pytest.fixture(scope="module")
def native_loaded():
    assert native_io._lib() is not None, (
        "the JAX tokenizer's native library did not load: the comparison "
        "would run against its str.split() fallback")


def test_trim_and_lowercase_equal_jax():
    for s in ODD_STRINGS:
        assert nlp.Trim().apply(s) == jax_nlp.Trim().apply(s)
        assert nlp.LowerCase().apply(s) == jax_nlp.LowerCase().apply(s)


def test_tokenizer_default_pattern_equals_jax_native(native_loaded):
    for s in ODD_STRINGS:
        assert nlp.Tokenizer().apply(s) == jax_nlp.Tokenizer().apply(s), s
    assert nlp.Tokenizer().apply("a\x0bb c\x0cd e\xa0f  g\th") == [
        "a\x0bb", "c\x0cd", "e\xa0f", "g", "h"]
    # str.split() splits where the native scanner does not
    assert "a\x0bb c".split() != nlp.Tokenizer().apply("a\x0bb c")


@pytest.mark.parametrize("pattern", ["[,;]+", "\\s+", "[^a-z]+"])
def test_tokenizer_other_patterns_equal_jax(pattern):
    for s in ODD_STRINGS + ["a,b;;c", "x1y22z"]:
        assert (nlp.Tokenizer(pattern).apply(s)
                == jax_nlp.Tokenizer(pattern).apply(s))


def test_tokenizer_batch_path_maps_items(native_loaded):
    out = (nlp.Trim().to_pipeline() >> nlp.LowerCase() >> nlp.Tokenizer())(
        HostDataset(ODD_STRINGS, device="cpu")).get()
    want = (jax_nlp.Trim().to_pipeline() >> jax_nlp.LowerCase()
            >> jax_nlp.Tokenizer())(JaxHostDataset(ODD_STRINGS)).get()
    assert isinstance(out, HostDataset)
    assert out.items == want.items
    assert out.device == "cpu"


@pytest.mark.parametrize("orders", [(1, 2), [3], (2, 1, 3)])
def test_ngrams_featurizer_equals_jax(orders):
    for tokens in ([], ["a"], ["a", "b"], list("abcdefg")):
        assert (nlp.NGramsFeaturizer(orders).apply(tokens)
                == jax_nlp.NGramsFeaturizer(orders).apply(tokens))
    with pytest.raises(ValueError):
        nlp.NGramsFeaturizer([0])


@pytest.mark.parametrize("mode", ["default", "no-add"])
def test_ngrams_counts_equal_jax(mode):
    tokens = [d.split() for d in _docs(30, 12, 20, seed=3)]
    grams = nlp.NGramsFeaturizer([2]).apply_batch(HostDataset(tokens))
    jgrams = jax_nlp.NGramsFeaturizer([2]).apply_batch(JaxHostDataset(tokens))
    assert grams.items == jgrams.items
    got = nlp.NGramsCounts(mode).apply_batch(grams).items
    want = jax_nlp.NGramsCounts(mode).apply_batch(jgrams).items
    assert got == want
    assert nlp.NGramsCounts(mode).apply(grams.items[0]) == Counter(
        grams.items[0])
    with pytest.raises(ValueError):
        nlp.NGramsCounts("sum")


def test_term_frequency_sqrt_equals_jax():
    for tokens in (["a", "b", "a", "c", "a", "b"], [], ["x"] * 9):
        got = nlp.TermFrequency(math.sqrt).apply(tokens)
        assert got == jax_nlp.TermFrequency(math.sqrt).apply(tokens)
    assert nlp.TermFrequency().apply(["a", "a"]) == [("a", 2)]


def test_hashing_nodes_equal_jax_in_one_process():
    """Python's `hash()` is salted per process: the columns agree within
    one process only."""
    tokens = _docs(1, 50, 40, seed=4)[0].split()
    np.testing.assert_array_equal(nlp.HashingTF(64).apply(tokens),
                                  jax_nlp.HashingTF(64).apply(tokens))
    np.testing.assert_array_equal(
        nlp.NGramsHashingTF((1, 2), 97).apply(tokens),
        jax_nlp.NGramsHashingTF((1, 2), 97).apply(tokens))
    assert nlp.HashingTF(64).apply(tokens).sum() == len(tokens)


def test_ngram_key_equals_jax():
    a, b = nlp.NGram(["x", "y"]), nlp.NGram(("x", "y"))
    assert a == b and hash(a) == hash(jax_nlp.NGram(["x", "y"]))
    assert repr(a) == repr(jax_nlp.NGram(["x", "y"])) == "[x,y]"
    assert a != nlp.NGram(["y", "x"])


def test_word_frequency_encoder_equals_jax_with_ties():
    tokens = [["b", "a", "c", "a"], ["c", "b", "d"], ["e", "d"]]
    enc = nlp.WordFrequencyEncoder().fit(HostDataset(tokens))
    jenc = jax_nlp.WordFrequencyEncoder().fit(JaxHostDataset(tokens))
    # a, b, c and d tie at 2: ranked by the word
    assert enc.vocab == jenc.vocab == {"a": 0, "b": 1, "c": 2, "d": 3,
                                       "e": 4}
    assert enc.word_counts == jenc.word_counts
    assert enc.apply(["d", "zz", "a"]) == jenc.apply(["d", "zz", "a"]) == [
        3, -1, 0]
    docs = [d.split() for d in _docs(40, 30, 15, seed=5)]
    assert (nlp.WordFrequencyEncoder().fit(HostDataset(docs)).vocab
            == jax_nlp.WordFrequencyEncoder().fit(JaxHostDataset(docs)).vocab)


def _pairs(docs):
    feat = (nlp.Trim().to_pipeline() >> nlp.LowerCase() >> nlp.Tokenizer()
            >> nlp.NGramsFeaturizer((1, 2))
            >> nlp.TermFrequency(math.sqrt))
    return feat(HostDataset(docs, device="cpu")).get()


def _assert_same_csr(got: sp.csr_matrix, want: sp.csr_matrix):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.dtype == want.dtype == np.float32


def test_common_sparse_features_cut_inside_tied_counts_equals_jax():
    docs = _docs(60, 25, 12, seed=6)
    pairs = _pairs(docs)
    counts = sorted(Counter(f for p in pairs.items for f, _ in p).values(),
                    reverse=True)
    # a cut whose last kept count is shared with the first dropped one
    cut = next(k for k in range(len(counts) // 3, len(counts))
               if counts[k - 1] == counts[k]
               and counts.count(counts[k]) >= 4)
    vec = sf.CommonSparseFeatures(cut).fit(pairs)
    jpairs = JaxHostDataset(pairs.items)
    jvec = jax_sf.CommonSparseFeatures(cut).fit(jpairs)
    assert len(vec.vocab) == cut
    assert vec.vocab == jvec.vocab
    out = vec.apply_batch(pairs)
    assert isinstance(out, SparseDataset) and out.device == "cpu"
    _assert_same_csr(out.matrix, jvec.apply_batch(jpairs).matrix)


def test_all_sparse_features_and_single_datum_equal_jax():
    pairs = _pairs(_docs(20, 15, 10, seed=7))
    jpairs = JaxHostDataset(pairs.items)
    vec = sf.AllSparseFeatures().fit(pairs)
    jvec = jax_sf.AllSparseFeatures().fit(jpairs)
    assert vec.vocab == jvec.vocab
    _assert_same_csr(vec.apply_batch(pairs).matrix,
                     jvec.apply_batch(jpairs).matrix)
    # one datum: a 1 × V row; duplicates sum, unknown features drop
    item = pairs.items[3] + [(("w1",), 2.0), (("w1",), 0.5), (("zz",), 9.0)]
    row, jrow = vec.apply(item), jvec.apply(item)
    assert row.shape == (1, len(vec.vocab))
    np.testing.assert_array_equal(row.toarray(), jrow.toarray())


def test_sparse_dataset_matches_jax_and_its_device_forms():
    rng = np.random.default_rng(8)
    dense = rng.random((9, 13)).astype(np.float32)
    dense[dense < 0.7] = 0.0
    ds = SparseDataset(sp.csr_matrix(dense), device="cpu")
    jds = JaxSparseDataset(sp.csr_matrix(dense))
    assert (ds.count, ds.dim, len(ds)) == (jds.count, jds.dim, len(jds))
    assert ds.sparsity == jds.sparsity and ds.nnz == jds.matrix.nnz
    assert ds.numpy() is ds.matrix and ds.cache() is ds
    assert repr(ds) == repr(jds)
    double = lambda m: m * 2  # noqa: E731
    np.testing.assert_array_equal(ds.map_rows(double).matrix.toarray(),
                                  jds.map_rows(double).matrix.toarray())
    # one device: the JAX package's linspace pick at k rows in all
    picked = ds.sample_per_shard(4).matrix.toarray()
    np.testing.assert_array_equal(
        picked, dense[np.linspace(0, 8, num=4, dtype=np.int64)])
    # the device CSRs: made once, X and Xᵀ
    X, Xt = ds.csr(), ds.csr_t()
    assert X.layout == torch.sparse_csr and Xt.layout == torch.sparse_csr
    assert ds.csr() is X and ds.csr_t() is Xt
    np.testing.assert_array_equal(X.to_dense().numpy(), dense)
    np.testing.assert_array_equal(Xt.to_dense().numpy(), dense.T)
    np.testing.assert_array_equal(ds.densify().numpy(),
                                  np.asarray(jds.densify().array)[:9])


def test_densify_and_sparsify_equal_jax():
    rng = np.random.default_rng(9)
    dense = np.where(rng.random((6, 7)) < 0.5, 0.0,
                     rng.random((6, 7))).astype(np.float32)
    ds = SparseDataset(dense, device="cpu")
    got = basic.Densify().apply_batch(ds)
    assert isinstance(got, Dataset)
    np.testing.assert_array_equal(got.numpy(), dense)
    back = basic.Sparsify().apply_batch(got)
    assert isinstance(back, SparseDataset) and back.device == got.device
    _assert_same_csr(back.matrix, jax_basic.Sparsify().apply_batch(
        jax_basic.Densify().apply_batch(JaxSparseDataset(dense))).matrix)
    assert basic.Sparsify().apply_batch(ds) is ds
    assert basic.Densify().apply_batch(got) is got
    row = sp.csr_matrix(dense[2:3])
    np.testing.assert_array_equal(basic.Densify().apply(row),
                                  jax_basic.Densify().apply(row))
    np.testing.assert_array_equal(
        basic.Sparsify().apply(torch.from_numpy(dense[1])).toarray(),
        jax_basic.Sparsify().apply(dense[1]).toarray())


class _NoItems(ItemTransformer):
    def apply(self, x):
        raise AssertionError("a SparseDataset took the one-datum path")

    def apply_batch(self, data):
        return data.count


def test_executor_takes_the_batch_path_for_a_sparse_dataset():
    ds = SparseDataset(np.eye(3, dtype=np.float32), device="cpu")
    assert _NoItems()(ds).get() == 3
    out = basic.Densify()(ds).get()
    assert isinstance(out, Dataset)
    np.testing.assert_array_equal(out.numpy(), np.eye(3))
    # one datum: a 1 × V row goes through `apply`
    row = basic.Densify()(sp.csr_matrix(np.eye(3)[1:2])).get()
    np.testing.assert_array_equal(row, [0.0, 1.0, 0.0])


def _zipf_docs(seed):
    rng = np.random.default_rng(seed)
    vocab = [f"t{i}" for i in range(300)]
    return [[vocab[j] for j in rng.zipf(1.4, size=40) % 300]
            for _ in range(120)]


def test_stupid_backoff_models_equal_jax():
    """The recursive model and the packed one (sorted bit-packed keys,
    one search an order) score every query class as JAX's do: seen
    trigrams, backed-off bigrams, unknown words, bare unigrams."""
    docs = _zipf_docs(11)
    ngrams, unigrams = Counter(), Counter()
    for toks in docs:
        for o in (2, 3):
            for i in range(len(toks) - o + 1):
                ngrams[tuple(toks[i:i + o])] += 1
        unigrams.update(toks)
    queries = [tuple(t[i:i + 3]) for t in docs[:30]
               for i in range(len(t) - 2)]
    queries += [("t1", "t2"), ("t5",), ("oov-x", "t2", "t3"),
                ("t1", "oov-x", "t3"), ("t1", "t2", "oov-x"), ("oov-x",)]
    model = nlp.StupidBackoffEstimator(dict(unigrams)).fit(
        HostDataset([ngrams]))
    jmodel = jax_nlp.StupidBackoffEstimator(dict(unigrams)).fit(
        JaxHostDataset([ngrams]))
    assert [model.score(q) for q in queries] == [jmodel.score(q)
                                                 for q in queries]
    assert model.apply_batch(HostDataset(queries)).items == \
        jmodel.apply_batch(JaxHostDataset(queries)).items
    packed = nlp.PackedStupidBackoffEstimator().fit(HostDataset(docs))
    jpacked = jax_nlp.PackedStupidBackoffEstimator().fit(
        JaxHostDataset(docs))
    np.testing.assert_array_equal(packed.keys, jpacked.keys)
    np.testing.assert_array_equal(packed.counts, jpacked.counts)
    assert packed.vocab == jpacked.vocab and packed.nbytes == jpacked.nbytes
    np.testing.assert_array_equal(packed.score_batch(queries),
                                  jpacked.score_batch(queries))
    np.testing.assert_allclose(packed.score_batch(queries),
                               [model.score(q) for q in queries],
                               rtol=1e-9, atol=1e-12)


def test_bitpack_indexers_equal_jax():
    for cls, jcls in ((nlp.NaiveBitPackIndexer, jax_nlp.NaiveBitPackIndexer),
                      (nlp.BackoffIndexer, jax_nlp.BackoffIndexer)):
        idx, jidx = cls(), jcls()
        for words in ([0], [3, 7], [3, 7, 11], [(1 << 20) - 2, 0, 5]):
            packed = idx.pack(words)
            assert packed == jidx.pack(words)
            assert idx.unpack(packed) == words
            if len(words) > 1:
                assert idx.remove_far_left_word(packed) == \
                    jidx.remove_far_left_word(packed)
        for bad in ([], [1, 2, 3, 4], [1 << 20]):
            with pytest.raises(ValueError):
                idx.pack(bad)
