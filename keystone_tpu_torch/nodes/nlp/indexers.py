"""N-gram packing indexers.

Counterpart of `keystone_tpu/nodes/nlp/indexers.py` (`:18-62`; reference
nodes/nlp/indexers.scala:5-135).

`NaiveBitPackIndexer` packs up to a trigram of word ids (20 bits each)
plus 4 control bits into one int64 — identical layout to the reference
(:50-70) so packed ids stay comparable/partitionable.
"""

from __future__ import annotations

from typing import List, Sequence

WORD_BITS = 20
WORD_MASK = (1 << WORD_BITS) - 1
# packed as w+1 so 0 marks absence: the largest storable id is MASK-1
MAX_WORD = WORD_MASK - 1


class NGramIndexer:
    """(indexers.scala:5-20)"""

    min_order = 1
    max_order = 3

    def pack(self, words: Sequence[int]) -> int:
        raise NotImplementedError

    def unpack(self, packed: int) -> List[int]:
        raise NotImplementedError


class NaiveBitPackIndexer(NGramIndexer):
    """Bit-packs [w1, w2, w3] as w1 | w2<<20 | w3<<40 | order<<60
    (indexers.scala:50-100)."""

    def pack(self, words: Sequence[int]) -> int:
        order = len(words)
        if not (1 <= order <= 3):
            raise ValueError("NaiveBitPackIndexer supports orders 1..3")
        packed = 0
        for i, w in enumerate(words):
            if not (0 <= w <= MAX_WORD):
                raise ValueError(f"word id {w} exceeds {WORD_BITS} bits")
            packed |= (w + 1) << (WORD_BITS * i)  # +1 so 0 marks absence
        return packed | (order << 60)

    def unpack(self, packed: int) -> List[int]:
        order = packed >> 60
        return [
            ((packed >> (WORD_BITS * i)) & WORD_MASK) - 1 for i in range(order)
        ]

    def remove_far_left_word(self, packed: int) -> int:
        """Drop the leftmost (oldest) word — the backoff step
        (indexers.scala:102-120)."""
        words = self.unpack(packed)
        if len(words) <= 1:
            raise ValueError("cannot back off a unigram")
        return self.pack(words[1:])


class BackoffIndexer(NaiveBitPackIndexer):
    """(indexers.scala:122-135) — the packing used by stupid backoff."""
