"""Perceptron sequence taggers (Collins 2002): host Python.

Counterpart of `keystone_tpu/nodes/nlp/perceptron_tagger.py`: the
feature templates `_shape` and `_features` (`:21-61`), the greedy
`AveragedPerceptronTagger` (`:64-151`), the tag-history-free
`_emission_features` (`:154-175`), the Viterbi-decoded
`StructuredPerceptronTagger` (`:178-330`) and `load_tagged_corpus`
(`:333-348`), copied. Training shuffles with `random.Random(seed)` as
JAX's does, so weights, tags and saved JSON equal JAX's, and a file saved
by either package loads in the other (`tests/test_torch_nlp_taggers.py`).
Tagging is sequential work over ragged token lists, as in the
reference's JVM-side annotators (POSTagger.scala:24-36,
NER.scala:20-32), so it stays on the host.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple


def _shape(word: str) -> str:
    out = []
    for ch in word:
        if ch.isupper():
            c = "X"
        elif ch.islower():
            c = "x"
        elif ch.isdigit():
            c = "d"
        else:
            c = ch
        if not out or out[-1] != c:
            out.append(c)
    return "".join(out)


def _features(
    tokens: Sequence[str], i: int, prev_tag: str, prev2_tag: str
) -> List[str]:
    w = tokens[i]
    low = w.lower()
    prev_w = tokens[i - 1].lower() if i > 0 else "<s>"
    next_w = tokens[i + 1].lower() if i + 1 < len(tokens) else "</s>"
    return [
        "bias",
        "w=" + low,
        "suf3=" + low[-3:],
        "suf2=" + low[-2:],
        "pre1=" + low[:1],
        "shape=" + _shape(w),
        "isdigit=" + str(w.replace(".", "").replace(",", "").isdigit()),
        "istitle=" + str(w.istitle()),
        "first=" + str(i == 0),
        "pt=" + prev_tag,
        "pt2=" + prev_tag + "|" + prev2_tag,
        "pw=" + prev_w,
        "nw=" + next_w,
        "pw+w=" + prev_w + "|" + low,
    ]


class AveragedPerceptronTagger:
    """Greedy averaged-perceptron tagger; callable as token list → tags
    so it slots directly into POSTagger/NER ``model=``."""

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.tags: List[str] = []

    # ------------------------------------------------------------- inference

    def _score(self, feats: Sequence[str]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for f in feats:
            for tag, w in self.weights.get(f, {}).items():
                scores[tag] += w
        return scores

    def predict(self, tokens: Sequence[str]) -> List[str]:
        prev, prev2 = "<s>", "<s>"
        out = []
        for i in range(len(tokens)):
            scores = self._score(_features(tokens, i, prev, prev2))
            tag = max(self.tags, key=lambda t: (scores.get(t, 0.0), t))
            out.append(tag)
            prev2, prev = prev, tag
        return out

    __call__ = predict

    # -------------------------------------------------------------- training

    def train(
        self,
        sentences: Iterable[Sequence[Tuple[str, str]]],
        n_iter: int = 8,
        seed: int = 0,
    ) -> "AveragedPerceptronTagger":
        sentences = [list(s) for s in sentences]
        self.tags = sorted({t for s in sentences for _, t in s})
        totals: Dict[Tuple[str, str], float] = defaultdict(float)
        stamps: Dict[Tuple[str, str], int] = defaultdict(int)
        raw: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self.weights = raw
        rng = random.Random(seed)
        step = 0
        for _ in range(n_iter):
            rng.shuffle(sentences)
            for sent in sentences:
                tokens = [w for w, _ in sent]
                prev, prev2 = "<s>", "<s>"
                for i, (_, gold) in enumerate(sent):
                    feats = _features(tokens, i, prev, prev2)
                    scores = self._score(feats)
                    guess = max(self.tags, key=lambda t: (scores.get(t, 0.0), t))
                    if guess != gold:
                        for f in feats:
                            for tag, delta in ((gold, 1.0), (guess, -1.0)):
                                key = (f, tag)
                                # accumulate the area under the weight
                                # curve since last touch (lazy averaging)
                                totals[key] += (step - stamps[key]) * raw[f][tag]
                                stamps[key] = step
                                raw[f][tag] += delta
                    prev2, prev = prev, gold  # teacher-forced history
                    step += 1
        averaged: Dict[str, Dict[str, float]] = {}
        for (f, tag), total in totals.items():
            total += (step - stamps[(f, tag)]) * raw[f][tag]
            avg = total / step
            if abs(avg) > 1e-12:
                averaged.setdefault(f, {})[tag] = avg
        self.weights = averaged
        return self

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"tags": self.tags, "weights": self.weights}, f)

    @classmethod
    def load(cls, path: str) -> "AveragedPerceptronTagger":
        with open(path) as f:
            blob = json.load(f)
        t = cls()
        t.tags = blob["tags"]
        t.weights = blob["weights"]
        return t


def _emission_features(tokens: Sequence[str], i: int) -> List[str]:
    """Tag-history-free observation features: the structured model keeps
    tag context in explicit transition weights scored by Viterbi instead
    of greedy teacher-forced history features."""
    w = tokens[i]
    low = w.lower()
    prev_w = tokens[i - 1].lower() if i > 0 else "<s>"
    next_w = tokens[i + 1].lower() if i + 1 < len(tokens) else "</s>"
    return [
        "bias",
        "w=" + low,
        "suf3=" + low[-3:],
        "suf2=" + low[-2:],
        "pre1=" + low[:1],
        "shape=" + _shape(w),
        "isdigit=" + str(w.replace(".", "").replace(",", "").isdigit()),
        "istitle=" + str(w.istitle()),
        "first=" + str(i == 0),
        "pw=" + prev_w,
        "nw=" + next_w,
        "pw+w=" + prev_w + "|" + low,
    ]


class StructuredPerceptronTagger:
    """Structured perceptron with first-order Viterbi decoding (Collins
    2002, the exact-search variant): scores whole tag sequences as
    Σᵢ emission(xᵢ, tᵢ) + transition(tᵢ₋₁, tᵢ), trains with sequence-level
    updates Φ(x, gold) − Φ(x, ŷ), and averages weights. One model class
    above the greedy `AveragedPerceptronTagger` (global argmax vs greedy
    left-to-right) and the self-contained analog of the reference's Epic
    CRF wrappers (POSTagger.scala:24-36, NER.scala:20-32) — same
    factorization as a linear-chain CRF, perceptron-trained."""

    START = "<s>"

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.trans: Dict[Tuple[str, str], float] = {}
        self.tags: List[str] = []

    # ------------------------------------------------------------- inference

    def _emissions(self, tokens: Sequence[str]) -> List[Dict[str, float]]:
        out = []
        for i in range(len(tokens)):
            scores: Dict[str, float] = defaultdict(float)
            for f in _emission_features(tokens, i):
                for tag, w in self.weights.get(f, {}).items():
                    scores[tag] += w
            out.append(scores)
        return out

    def predict(self, tokens: Sequence[str]) -> List[str]:
        if not tokens:
            return []
        T = self.tags
        emis = self._emissions(tokens)
        # Viterbi lattice: delta[t] = best score of any path ending in t
        delta = {
            t: emis[0].get(t, 0.0) + self.trans.get((self.START, t), 0.0)
            for t in T
        }
        back: List[Dict[str, str]] = []
        for i in range(1, len(tokens)):
            new_delta: Dict[str, float] = {}
            bp: Dict[str, str] = {}
            for t in T:
                e = emis[i].get(t, 0.0)
                # deterministic tie-break on (score, prev-tag name)
                best_prev = max(
                    T, key=lambda p: (delta[p] + self.trans.get((p, t), 0.0), p)
                )
                new_delta[t] = (
                    delta[best_prev] + self.trans.get((best_prev, t), 0.0) + e
                )
                bp[t] = best_prev
            delta = new_delta
            back.append(bp)
        last = max(T, key=lambda t: (delta[t], t))
        path = [last]
        for bp in reversed(back):
            path.append(bp[path[-1]])
        return path[::-1]

    __call__ = predict

    # -------------------------------------------------------------- training

    def train(
        self,
        sentences: Iterable[Sequence[Tuple[str, str]]],
        n_iter: int = 10,
        seed: int = 0,
    ) -> "StructuredPerceptronTagger":
        sentences = [list(s) for s in sentences]
        self.tags = sorted({t for s in sentences for _, t in s})
        raw_e: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        raw_t: Dict[Tuple[str, str], float] = defaultdict(float)
        tot_e: Dict[Tuple[str, str], float] = defaultdict(float)
        stamp_e: Dict[Tuple[str, str], int] = defaultdict(int)
        tot_t: Dict[Tuple[str, str], float] = defaultdict(float)
        stamp_t: Dict[Tuple[str, str], int] = defaultdict(int)
        self.weights, self.trans = raw_e, raw_t
        rng = random.Random(seed)
        step = 0

        def bump_e(f: str, tag: str, delta: float) -> None:
            key = (f, tag)
            tot_e[key] += (step - stamp_e[key]) * raw_e[f][tag]
            stamp_e[key] = step
            raw_e[f][tag] += delta

        def bump_t(prev: str, tag: str, delta: float) -> None:
            key = (prev, tag)
            tot_t[key] += (step - stamp_t[key]) * raw_t[key]
            stamp_t[key] = step
            raw_t[key] += delta

        for _ in range(n_iter):
            rng.shuffle(sentences)
            for sent in sentences:
                step += 1
                tokens = [w for w, _ in sent]
                gold = [t for _, t in sent]
                pred = self.predict(tokens)
                if pred == gold:
                    continue
                prev_g = prev_p = self.START
                for i in range(len(tokens)):
                    g, p = gold[i], pred[i]
                    if g != p:
                        for f in _emission_features(tokens, i):
                            bump_e(f, g, 1.0)
                            bump_e(f, p, -1.0)
                    if (prev_g, g) != (prev_p, p):
                        bump_t(prev_g, g, 1.0)
                        bump_t(prev_p, p, -1.0)
                    prev_g, prev_p = g, p
        step += 1
        averaged_e: Dict[str, Dict[str, float]] = {}
        for (f, tag), total in tot_e.items():
            total += (step - stamp_e[(f, tag)]) * raw_e[f][tag]
            avg = total / step
            if abs(avg) > 1e-12:
                averaged_e.setdefault(f, {})[tag] = avg
        averaged_t: Dict[Tuple[str, str], float] = {}
        for key, total in tot_t.items():
            total += (step - stamp_t[key]) * raw_t[key]
            avg = total / step
            if abs(avg) > 1e-12:
                averaged_t[key] = avg
        self.weights, self.trans = averaged_e, averaged_t
        return self

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "tags": self.tags,
                    "weights": self.weights,
                    "trans": [[p, t, w] for (p, t), w in self.trans.items()],
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "StructuredPerceptronTagger":
        with open(path) as f:
            blob = json.load(f)
        t = cls()
        t.tags = blob["tags"]
        t.weights = blob["weights"]
        t.trans = {(p, tg): w for p, tg, w in blob["trans"]}
        return t


def load_tagged_corpus(path: str) -> List[List[Tuple[str, str]]]:
    """One sentence per line, ``token/TAG`` entries separated by spaces
    (the classic slash format; slashes inside tokens are not supported
    by the bundled corpora)."""
    sentences = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            pairs = []
            for item in line.split():
                tok, _, tag = item.rpartition("/")
                pairs.append((tok, tag))
            sentences.append(pairs)
    return sentences
