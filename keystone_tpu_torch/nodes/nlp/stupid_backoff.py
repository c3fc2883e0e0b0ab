"""Stupid-backoff language model (Brants et al. 2007): host numpy.

Counterpart of `keystone_tpu/nodes/nlp/stupid_backoff.py` (`:26-274`):
the recursive `StupidBackoffModel`/`Estimator` that StupidBackoffPipeline
runs, and the packed model over interned, bit-packed n-grams. Both are
host code in the JAX package and stay so here: the model is a lookup
table, and nothing of it runs on a device.

Reference: nodes/nlp/StupidBackoff.scala:14-182. The reference
partitions n-grams by their first two words (`InitialBigramPartitioner`,
:25-59) so backoff lookups stay partition-local on the cluster; here
scoring state is a host dict.

On a mesh's data axis (a `HostDataset` of this rank's items) both
estimators count this rank's items and merge the counts over the ranks
before building the model (`parallel.merge_counts`, and for the packed
model each rank's vocabulary, unigram counts and n-gram table through
`all_gather_objects`), so every rank holds the model of the whole
corpus, as JAX's fit over its whole host list.

S(w | w_{i-n+1..i-1}) = count(ngram)/count(context) if seen,
else α · S(w | shorter context), bottoming out at unigram frequency.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...data.dataset import HostDataset
from ...parallel.collectives import all_gather_objects, merge_counts
from ...workflow.pipeline import Estimator, ItemTransformer

ALPHA = 0.4


class StupidBackoffModel(ItemTransformer):
    def __init__(self, ngram_counts: Dict[tuple, int], unigram_counts: Dict[str, int],
                 total_tokens: int, alpha: float = ALPHA):
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.total_tokens = max(total_tokens, 1)
        self.alpha = alpha

    def score(self, ngram: Sequence[str]) -> float:
        ngram = tuple(ngram)
        if len(ngram) == 1:
            return self.unigram_counts.get(ngram[0], 0) / self.total_tokens
        count = self.ngram_counts.get(ngram, 0)
        if count > 0:
            context = ngram[:-1]
            ctx_count = (
                self.ngram_counts.get(context, 0)
                if len(context) > 1
                else self.unigram_counts.get(context[0], 0)
            )
            if ctx_count > 0:
                return count / ctx_count
        return self.alpha * self.score(ngram[1:])

    def apply(self, ngram):
        return self.score(ngram)

    def apply_batch(self, data):
        return HostDataset([self.score(x) for x in data.items])


class StupidBackoffEstimator(Estimator):
    """Fit from a dataset of (ngram tuple, count) pair lists or Counters
    (StupidBackoff.scala:61-182); on a mesh, every rank's counts."""

    mesh_aware = True  # the counts merged over the data axis

    def __init__(self, unigram_counts: Dict[str, int] = None, alpha: float = ALPHA):
        self.unigram_counts = unigram_counts
        self.alpha = alpha

    def fit(self, data) -> StupidBackoffModel:
        ngram_counts: Counter = Counter()
        for item in data.items:
            pairs = item.items() if isinstance(item, (dict, Counter)) else item
            for ng, c in pairs:
                ngram_counts[tuple(ng)] += c
        ngram_counts = merge_counts(ngram_counts, getattr(data, "mesh", None))
        unigrams = self.unigram_counts
        if unigrams is None:
            unigrams = Counter()
            for ng, c in ngram_counts.items():
                if len(ng) == 1:
                    unigrams[ng[0]] += c
        total = sum(unigrams.values())
        return StupidBackoffModel(dict(ngram_counts), dict(unigrams), total, self.alpha)


# --------------------------------------------------------------------------
# Reference-scale packed model


def _group_key(w1, w2, w3, order):
    """Sort key placing the FIRST TWO word ids in the most-significant
    bits: an n-gram and every context it backs off through share a key
    prefix, so after sorting they are adjacent and a context probe hits
    the same cache lines. This is the InitialBigramPartitioner locality
    idea (StupidBackoff.scala:25-59 — n-grams partitioned by their first
    two words so backoff lookups stay partition-local) reconstructed for
    a sorted flat array instead of cluster partitions. Word ids are
    stored +1 (0 = absent), 20 bits each as in NaiveBitPackIndexer."""
    return (
        (w1.astype(np.int64) + 1) << 44
    ) | ((w2.astype(np.int64) + 1) << 24) | (
        (w3.astype(np.int64) + 1) << 4
    ) | order.astype(np.int64)


class PackedStupidBackoffModel(ItemTransformer):
    """Stupid backoff over interned/bit-packed n-grams at reference
    corpus scale (StupidBackoff.scala:14-182).

    State is three flat arrays — sorted int64 group keys, int64 counts,
    and a (vocab,) unigram count vector — **12 bytes per distinct
    n-gram** plus the vocabulary dict, where the tuple-dict
    `StupidBackoffModel` costs several hundred bytes per entry (tuple of
    interned strs + dict slot). A 10M-type model is ~120 MB: memory is
    bounded by 12·types + vocab, NOT by corpus tokens.

    Scoring is ITERATIVE (no recursion): a whole query batch is scored
    with one `np.searchsorted` pass per order (3→2→1), masking resolved
    queries and multiplying α into the still-backing-off remainder —
    the vectorized equivalent of the reference's per-ngram recursion
    (StupidBackoff.scala:061-121) with partition-local context lookups.
    """

    def __init__(self, keys, counts, unigram, total_tokens, vocab,
                 alpha: float = ALPHA):
        self.keys = keys            # sorted int64 (distinct 2/3-grams)
        self.counts = counts        # int64, aligned with keys
        self.unigram = unigram      # (vocab,) int64
        self.total_tokens = max(int(total_tokens), 1)
        self.vocab = vocab          # str -> id
        self.alpha = alpha

    def _lookup(self, q):
        if len(self.keys) == 0:  # degenerate corpus: every doc < 2 tokens
            return np.zeros(len(q), np.int64)
        pos = np.searchsorted(self.keys, q)
        pos = np.minimum(pos, len(self.keys) - 1)
        hit = self.keys[pos] == q
        return np.where(hit, self.counts[pos], 0)

    def score_ids(self, ids: np.ndarray) -> np.ndarray:
        """ids: (B, 3) int64; -1 pads ABSENT slots on the left (so
        column 2 is always the predicted word) and -2 marks an OOV word
        (present but unseen — probes miss, α still applies, exactly as
        an unseen n-gram does in the recursive model)."""
        ids = np.asarray(ids, np.int64)
        B = ids.shape[0]
        out = np.zeros(B)
        mult = np.ones(B)
        active = np.ones(B, bool)
        V = len(self.unigram)
        qorder = (ids != -1).sum(axis=1)  # OOV slots count as present

        for order in (3, 2):
            eligible = active & (qorder >= order)
            if not eligible.any():
                continue
            cols = ids[:, 3 - order:]
            probeable = eligible & (cols >= 0).all(axis=1) & (
                cols < V).all(axis=1)
            hit_idx = np.empty(0, np.int64)
            if probeable.any():
                w = cols[probeable]
                if order == 3:
                    q = _group_key(w[:, 0], w[:, 1], w[:, 2],
                                   np.full(len(w), 3))
                    qc = _group_key(w[:, 0], w[:, 1],
                                    np.full(len(w), -1), np.full(len(w), 2))
                    ctx = self._lookup(qc)
                else:
                    q = _group_key(w[:, 0], w[:, 1],
                                   np.full(len(w), -1), np.full(len(w), 2))
                    ctx = self.unigram[w[:, 0]]
                cnt = self._lookup(q)
                ok = (cnt > 0) & (ctx > 0)
                hit_idx = np.flatnonzero(probeable)[ok]
                out[hit_idx] = mult[hit_idx] * (
                    cnt[ok] / np.maximum(ctx[ok], 1))
                active[hit_idx] = False
            # everything eligible that did NOT resolve backs off with α
            # (unseen n-gram, zero context, or OOV word — all the cases
            # the recursive model reaches via count==0)
            miss = eligible.copy()
            miss[hit_idx] = False
            mult[miss] *= self.alpha

        last = ids[:, 2]
        uni_ok = active & (last >= 0) & (last < V)
        idx = np.flatnonzero(uni_ok)
        out[idx] = mult[idx] * self.unigram[last[idx]] / self.total_tokens
        return out

    def score_batch(self, ngrams) -> np.ndarray:
        """Score an iterable of word-tuple n-grams (orders 1..3)."""
        ids = np.full((len(ngrams), 3), -1, np.int32)
        get = self.vocab.get
        for i, ng in enumerate(ngrams):
            o = len(ng)
            for j, wd in enumerate(ng):
                ids[i, 3 - o + j] = get(wd, -2)  # -2 = OOV (never matches)
        return self.score_ids(ids)

    def score(self, ngram: Sequence[str]) -> float:
        return float(self.score_batch([tuple(ngram)])[0])

    def apply(self, ngram):
        return self.score(ngram)

    def apply_batch(self, data):
        return HostDataset(list(self.score_batch(list(data.items))))

    @property
    def nbytes(self) -> int:
        return (self.keys.nbytes + self.counts.nbytes + self.unigram.nbytes)


def _unpack_key(keys: np.ndarray):
    """The (w1, w2, w3, order) of `_group_key`s, absent words -1."""
    field = (1 << 20) - 1
    return (((keys >> 44) & field) - 1, ((keys >> 24) & field) - 1,
            ((keys >> 4) & field) - 1, keys & 0xF)


def _merge_packed(parts):
    """One corpus's (vocab, unigram, keys, counts) from each rank's, in
    rank order: the words numbered in first-seen order over the ranks'
    documents, as one pass over the whole list numbers them, each rank's
    n-gram keys renumbered and their counts summed."""
    from .indexers import MAX_WORD

    vocab: Dict[str, int] = {}
    remaps = []
    for words, _, _, _ in parts:
        # the last entry maps an absent word (-1) to itself
        remaps.append(np.array([vocab.setdefault(w, len(vocab))
                                for w in words] + [-1], np.int64))
    if len(vocab) > MAX_WORD + 1:
        raise ValueError(f"vocabulary exceeds {MAX_WORD + 1} words; "
                         "the 20-bit packed layout cannot index it")
    unigram = np.zeros(max(len(vocab), 1), np.int64)
    keys, counts = [], []
    for remap, (words, uni, k, c) in zip(remaps, parts):
        unigram[remap[:len(words)]] += uni[:len(words)]
        w1, w2, w3, order = _unpack_key(k)
        keys.append(_group_key(remap[w1], remap[w2], remap[w3], order))
        counts.append(c)
    keys, inverse = np.unique(np.concatenate(keys), return_inverse=True)
    counts = np.bincount(inverse.reshape(-1),
                         weights=np.concatenate(counts).astype(np.float64),
                         minlength=len(keys)).astype(np.int64)
    return vocab, unigram, keys, counts


class PackedStupidBackoffEstimator(Estimator):
    """Fit the packed model straight from a token-list corpus with
    vectorized counting: intern words, build (n-2)·3 packed key arrays,
    `np.unique` with counts — no per-ngram python objects anywhere
    (StupidBackoff.scala:61-182 + InitialBigramPartitioner grouping). On
    a mesh each rank counts its documents and `_merge_packed` joins the
    ranks' tables."""

    mesh_aware = True  # the tables merged over the data axis

    def __init__(self, alpha: float = ALPHA):
        self.alpha = alpha

    def fit(self, data) -> PackedStupidBackoffModel:
        vocab, unigram, keys, counts = self._count(
            data.items if hasattr(data, "items") else list(data))
        parts = all_gather_objects((list(vocab), unigram, keys, counts),
                                   getattr(data, "mesh", None))
        if len(parts) > 1:
            vocab, unigram, keys, counts = _merge_packed(parts)
        if len(keys):
            # 12 bytes/type when counts fit uint32 (4.29e9 occurrences of
            # one n-gram ≈ a multi-TB corpus); int64 fallback beyond
            counts = counts.astype(
                np.uint32 if counts.max() < 2**32 else np.int64)
        else:
            counts = counts.astype(np.uint32)
        return PackedStupidBackoffModel(
            keys, counts, unigram, int(unigram.sum()), vocab, self.alpha)

    @staticmethod
    def _count(docs):
        """(vocab, unigram counts, sorted n-gram keys, their counts) of
        ``docs``."""
        from .indexers import MAX_WORD

        vocab: Dict[str, int] = {}
        id_docs = []
        for doc in docs:
            arr = np.empty(len(doc), np.int64)
            for i, wd in enumerate(doc):
                j = vocab.get(wd)
                if j is None:
                    j = len(vocab)
                    if j > MAX_WORD:
                        # same 20-bit-per-word limit (and error posture)
                        # as NaiveBitPackIndexer — overflowing the field
                        # would silently collide distinct n-gram keys
                        raise ValueError(
                            f"vocabulary exceeds {MAX_WORD + 1} words; "
                            "the 20-bit packed layout cannot index it")
                    vocab[wd] = j
                arr[i] = j
            id_docs.append(arr)
        V = len(vocab)
        unigram = np.zeros(max(V, 1), np.int64)
        tri_keys, bi_keys = [], []
        for arr in id_docs:
            np.add.at(unigram, arr, 1)
            n = len(arr)
            if n >= 2:
                bi_keys.append(_group_key(
                    arr[:-1], arr[1:],
                    np.full(n - 1, -1), np.full(n - 1, 2)))
            if n >= 3:
                tri_keys.append(_group_key(
                    arr[:-2], arr[1:-1], arr[2:], np.full(n - 2, 3)))
        parts = []
        for group in (bi_keys, tri_keys):
            if group:
                k, c = np.unique(np.concatenate(group), return_counts=True)
                parts.append((k, c))
        if parts:
            keys = np.concatenate([k for k, _ in parts])
            counts = np.concatenate([c for _, c in parts])
            order_ix = np.argsort(keys, kind="stable")
            keys, counts = keys[order_ix], counts[order_ix]
        else:
            keys = np.empty(0, np.int64)
            counts = np.empty(0, np.int64)
        return vocab, unigram, keys, counts
