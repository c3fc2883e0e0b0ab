"""Text nodes (counterpart of `keystone_tpu/nodes/nlp`): host Python,
but for the linear-chain CRF (`crf.py`), which fits and decodes on its
device."""

from .annotators import NER, CoreNLPFeatureExtractor, POSTagger
from .crf import LinearChainCRFTagger
from .indexers import BackoffIndexer, NaiveBitPackIndexer, NGramIndexer
from .stupid_backoff import (
    PackedStupidBackoffEstimator,
    PackedStupidBackoffModel,
    StupidBackoffEstimator,
    StupidBackoffModel,
)
from .synthetic_corpus import generate_ner_corpus, generate_pos_corpus
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

__all__ = ["BackoffIndexer", "CoreNLPFeatureExtractor", "HashingTF",
           "LinearChainCRFTagger", "LowerCase", "NER", "NGram",
           "NGramIndexer", "NGramsCounts", "NGramsFeaturizer",
           "NGramsHashingTF", "NaiveBitPackIndexer", "POSTagger",
           "PackedStupidBackoffEstimator", "PackedStupidBackoffModel",
           "StupidBackoffEstimator", "StupidBackoffModel", "TermFrequency",
           "Tokenizer", "Trim", "WordFrequencyEncoder",
           "generate_ner_corpus", "generate_pos_corpus"]
