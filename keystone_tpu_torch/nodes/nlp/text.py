"""Text processing nodes: host Python, as in the JAX package.

Counterpart of `keystone_tpu/nodes/nlp/text.py` (`:31-182`; reference
nodes/nlp/). Strings stay on the host (`:3-8`); the device boundary is
downstream, where `CommonSparseFeatures` vectorizes into a host CSR whose
arrays go to the card once (`data/sparse.py`).

- `Trim`, `LowerCase`, `Tokenizer` (`:31-55`; StringUtils.scala:13-29)
- `NGram`, `NGramsFeaturizer`, `NGramsCounts` (`:58-116`;
  ngrams.scala:20-185)
- `HashingTF`, `NGramsHashingTF` (`:119-146`; HashingTF.scala:15-31,
  NGramsHashingTF.scala:25-118)
- `TermFrequency` (`:149-158`; nodes/stats/TermFrequency.scala:19)
- `WordFrequencyEncoder` (`:161-182`; WordFrequencyEncoder.scala:7-62),
  whose counts on a mesh's data axis are merged over the ranks
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ...data.dataset import HostDataset
from ...parallel.collectives import merge_counts
from ...workflow.pipeline import Estimator, ItemTransformer

#: the default pattern, and the bytes JAX's native tokenizer splits on
#: (`native/keystone_io.cpp:171-190`, `ks_tokenize_ws`)
DEFAULT_PATTERN = "[\\s]+"
_NATIVE_WS = re.compile("[ \n\t\r]+")


class Trim(ItemTransformer):
    def apply(self, s: str) -> str:
        return s.strip()


class LowerCase(ItemTransformer):
    def apply(self, s: str) -> str:
        return s.lower()


class Tokenizer(ItemTransformer):
    """Regex-split tokenizer (StringUtils.scala `Tokenizer`), empty
    tokens dropped.

    The default pattern means what it means in the JAX package, whose
    default goes through its native scanner: a split on ``' '``,
    ``'\\n'``, ``'\\t'`` and ``'\\r'`` only, of the string's UTF-8 form
    with unencodable characters replaced (`utils/native_io.py:216-230`).
    Other whitespace (``'\\v'``, ``'\\f'``, ``'\\xa0'``, ...) stays inside
    tokens. Any other pattern splits as `re.split` does."""

    def __init__(self, pattern: str = DEFAULT_PATTERN):
        self.pattern_str = pattern
        self.pattern = re.compile(pattern)

    def apply(self, s: str) -> List[str]:
        if self.pattern_str == DEFAULT_PATTERN:
            s = s.encode("utf-8", errors="replace").decode("utf-8")
            return [t for t in _NATIVE_WS.split(s) if t]
        return [t for t in self.pattern.split(s) if t]


class NGram:
    """Hash/equals-correct n-gram key (ngrams.scala:100-130)."""

    __slots__ = ("words",)

    def __init__(self, words: Sequence[str]):
        self.words = tuple(words)

    def __hash__(self) -> int:
        return hash(self.words)

    def __eq__(self, other) -> bool:
        return isinstance(other, NGram) and self.words == other.words

    def __repr__(self) -> str:
        return "[" + ",".join(self.words) + "]"


class NGramsFeaturizer(ItemTransformer):
    """All n-grams of orders [min..max] of a token list, as tuples, the
    lower orders first (ngrams.scala:20-98)."""

    def __init__(self, orders: Sequence[int]):
        orders = sorted(orders)
        if not orders or orders[0] < 1:
            raise ValueError("ngram orders must be >= 1")
        self.orders = orders

    def apply(self, tokens: List[str]) -> List[Tuple[str, ...]]:
        out = []
        for n in self.orders:
            for i in range(len(tokens) - n + 1):
                out.append(tuple(tokens[i:i + n]))
        return out


class NGramsCounts(ItemTransformer):
    """Count n-grams (ngrams.scala:132-185). Mode ``'default'``: over
    the whole corpus, one item of (n-gram, count) pairs, most frequent
    first; ``'no-add'``: a `Counter` for each item."""

    def __init__(self, mode: str = "default"):
        if mode not in ("default", "no-add"):
            raise ValueError("mode must be 'default' or 'no-add'")
        self.mode = mode

    def apply(self, ngrams):
        return Counter(ngrams)

    def apply_batch(self, data):
        if self.mode == "no-add":
            return HostDataset([Counter(x) for x in data.items],
                               device=data.device)
        total: Counter = Counter()
        for item in data.items:
            total.update(item)
        pairs = sorted(total.items(), key=lambda kv: -kv[1])
        return HostDataset([pairs], device=data.device)


class HashingTF(ItemTransformer):
    """Feature hashing into a fixed-width count vector
    (HashingTF.scala:15-31). It hashes with Python's `hash()`, which is
    salted per process for strings, so its columns equal the JAX
    package's only within one process."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def apply(self, terms) -> np.ndarray:
        v = np.zeros(self.num_features, np.float32)
        for t in terms:
            v[hash(t) % self.num_features] += 1.0
        return v


class NGramsHashingTF(ItemTransformer):
    """NGramsFeaturizer then HashingTF in one node
    (NGramsHashingTF.scala:25-118). Python's `hash()` of the n-gram
    tuple: equal to the JAX package's only within one process."""

    def __init__(self, orders: Sequence[int], num_features: int):
        self.featurizer = NGramsFeaturizer(orders)
        self.num_features = num_features

    def apply(self, tokens) -> np.ndarray:
        v = np.zeros(self.num_features, np.float32)
        for ng in self.featurizer.apply(tokens):
            v[hash(ng) % self.num_features] += 1.0
        return v


class TermFrequency(ItemTransformer):
    """terms → (term, fn(count)) pairs in first-seen order
    (nodes/stats/TermFrequency.scala:19). ``fn`` defaults to the
    identity; `math.sqrt` gives sublinear tf."""

    def __init__(self, fn: Optional[Callable[[float], float]] = None):
        self.fn = fn or (lambda x: x)

    def apply(self, terms):
        return [(t, self.fn(c)) for t, c in Counter(terms).items()]


class _WordFrequencyTransformer(ItemTransformer):
    def __init__(self, vocab: dict):
        self.vocab = vocab  # word -> rank by frequency; unknown -> -1

    def apply(self, tokens):
        return [self.vocab.get(t, -1) for t in tokens]


class WordFrequencyEncoder(Estimator):
    """Fit a vocabulary ranked by frequency, ties by the word; the
    transformer maps a word to its rank and an unknown word to -1
    (WordFrequencyEncoder.scala:7-62). ``word_counts`` holds the
    counts; on a mesh's data axis every rank's, merged
    (`parallel.merge_counts`) before ranking."""

    mesh_aware = True  # the counts merged over the data axis

    def fit(self, data) -> _WordFrequencyTransformer:
        counts: Counter = Counter()
        for tokens in data.items:
            counts.update(tokens)
        counts = merge_counts(counts, getattr(data, "mesh", None))
        vocab = {w: i for i, (w, _) in enumerate(
            sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))}
        t = _WordFrequencyTransformer(vocab)
        t.word_counts = dict(counts)
        return t
