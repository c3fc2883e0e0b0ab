"""Text nodes (counterpart of `keystone_tpu/nodes/nlp`): host Python.

The POS/NER side (`annotators.py`, `crf.py`, `perceptron_tagger.py`,
`synthetic_corpus.py`) is not ported yet (ROADMAP queue 1, item 7).
"""

from .indexers import BackoffIndexer, NaiveBitPackIndexer, NGramIndexer
from .stupid_backoff import (
    PackedStupidBackoffEstimator,
    PackedStupidBackoffModel,
    StupidBackoffEstimator,
    StupidBackoffModel,
)
from .text import (
    HashingTF,
    LowerCase,
    NGram,
    NGramsCounts,
    NGramsFeaturizer,
    NGramsHashingTF,
    TermFrequency,
    Tokenizer,
    Trim,
    WordFrequencyEncoder,
)

__all__ = ["BackoffIndexer", "HashingTF", "LowerCase", "NGram",
           "NGramIndexer", "NGramsCounts", "NGramsFeaturizer",
           "NGramsHashingTF", "NaiveBitPackIndexer",
           "PackedStupidBackoffEstimator", "PackedStupidBackoffModel",
           "StupidBackoffEstimator", "StupidBackoffModel", "TermFrequency",
           "Tokenizer", "Trim", "WordFrequencyEncoder"]
