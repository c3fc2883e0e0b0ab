"""Grammar-templated synthetic tagged corpora (POS and NER): host Python.

Counterpart of `keystone_tpu/nodes/nlp/synthetic_corpus.py`: the
vocabulary and inflection rules (`:25-165`), `_PosGrammar` (`:167-231`),
`generate_pos_corpus` (`:233-238`) and `generate_ner_corpus`
(`:240-282`), copied. Both generators draw from `random.Random(seed)`
in the same order as the JAX package's, so a corpus equals JAX's token
for token (`tests/test_torch_nlp_taggers.py`). The reference's POS and
NER nodes wrap Epic's downloaded CRF models (POSTagger.scala:24-36,
NER.scala:20-32); these corpora take the download's place.
"""

from __future__ import annotations

import random
from typing import List, Tuple

Sentence = List[Tuple[str, str]]

# ----------------------------------------------------------------- vocabulary

_NOUN_STEMS = [
    "market", "report", "plan", "price", "company", "group", "system",
    "program", "problem", "question", "number", "result", "interest",
    "rate", "profit", "share", "deal", "offer", "order", "account",
    "bank", "board", "budget", "contract", "cost", "country", "customer",
    "decision", "demand", "economy", "effort", "employee", "factory",
    "firm", "fund", "growth", "industry", "investor", "issue", "job",
    "law", "leader", "loss", "manager", "meeting", "member", "model",
    "month", "office", "official", "owner", "partner", "payment",
    "period", "policy", "power", "president", "product", "project",
    "quarter", "record", "region", "rule", "sale", "sector", "service",
    "stake", "statement", "stock", "strategy", "supply", "tax", "team",
    "trade", "union", "unit", "value", "week", "worker", "year", "agency",
    "analyst", "asset", "balance", "benefit", "bond", "business",
    "capital", "chairman", "charge", "claim", "client", "committee",
    "concern", "credit", "debt", "director", "dividend", "dollar",
    "earning", "exchange", "executive", "expense", "export", "figure",
    "gain", "government", "holding", "income", "increase", "index",
    "investment", "level", "line", "loan", "maker", "margin", "measure",
    "merger", "operation", "option", "output", "part", "plant",
    "position", "purchase", "range", "reserve", "return", "revenue",
    "risk", "security", "spending", "venture", "volume", "yield",
]
# stems that are ALSO verbs — the ambiguity the transitions must resolve
_NOUN_VERB_STEMS = [
    "report", "plan", "offer", "order", "deal", "share", "claim",
    "charge", "increase", "gain", "return", "record", "trade", "demand",
    "measure", "purchase", "supply", "balance", "value", "cost",
]
_VERB_STEMS = [
    "announce", "approve", "ask", "become", "begin", "believe", "build",
    "buy", "call", "carry", "change", "close", "complete", "consider",
    "continue", "cut", "decline", "develop", "discuss", "drop", "earn",
    "expand", "expect", "fall", "finish", "follow", "grow", "help",
    "hold", "improve", "include", "join", "keep", "launch", "lead",
    "leave", "lift", "lower", "maintain", "manage", "move", "name",
    "need", "open", "operate", "pay", "post", "produce", "provide",
    "raise", "reach", "receive", "reduce", "reject", "remain", "rise",
    "say", "see", "sell", "send", "show", "sign", "slip", "start",
    "stop", "support", "take", "tell", "want", "win",
] + _NOUN_VERB_STEMS
_ADJ = [
    "new", "big", "small", "large", "high", "low", "good", "strong",
    "weak", "major", "minor", "local", "foreign", "federal", "private",
    "public", "recent", "early", "late", "annual", "current", "final",
    "financial", "economic", "industrial", "corporate", "national",
    "international", "key", "net", "gross", "total", "average", "chief",
    "senior", "former", "possible", "likely", "available", "additional",
    "certain", "common", "competitive", "daily", "direct", "domestic",
    "double", "efficient", "equal", "fair", "firm", "flat", "fresh",
    "full", "general", "global", "heavy", "huge", "important", "joint",
    "long", "modest", "narrow", "open", "overall", "potential", "prior",
    "quick", "rapid", "regional", "separate", "sharp", "short",
    "significant", "similar", "slow", "solid", "special", "stable",
    "steady", "strategic", "tight", "tough", "wide",
]
# -ly adverbs derived from adjectives + a few irregulars
_ADV = [a + "ly" for a in (
    "quick", "slow", "sharp", "steady", "rapid", "significant", "recent",
    "current", "general", "direct", "equal", "modest", "separate",
    "similar", "special", "usual", "wide",
)] + ["soon", "now", "here", "again", "still", "already", "often", "also"]
_FIRST_NAMES = [
    "James", "Mary", "John", "Patricia", "Robert", "Jennifer", "Michael",
    "Linda", "David", "Elizabeth", "William", "Barbara", "Richard",
    "Susan", "Joseph", "Jessica", "Thomas", "Sarah", "Charles", "Karen",
    "Christopher", "Nancy", "Daniel", "Lisa", "Matthew", "Betty", "Anna",
    "Mark", "Sandra", "Donald", "Ashley", "Steven", "Kimberly", "Paul",
    "Emily", "Andrew", "Donna", "Joshua", "Michelle", "Kenneth", "Carol",
]
_LAST_NAMES = [
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia", "Miller",
    "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez", "Gonzalez",
    "Wilson", "Anderson", "Thomas", "Taylor", "Moore", "Jackson",
    "Martin", "Lee", "Thompson", "White", "Harris", "Clark", "Lewis",
    "Robinson", "Walker", "Hall", "Young", "King", "Wright", "Scott",
    "Green", "Baker", "Adams", "Nelson", "Hill", "Campbell", "Mitchell",
]
_ORG_HEADS = [
    "Acme", "Global", "National", "United", "Pacific", "Atlantic",
    "Northern", "Southern", "Western", "Eastern", "General", "Standard",
    "Federal", "Continental", "Metro", "Summit", "Pinnacle", "Vertex",
    "Quantum", "Stellar", "Apex", "Nova", "Orion", "Delta", "Sigma",
]
_ORG_TAILS = ["Corp", "Inc", "Group", "Holdings", "Industries",
              "Systems", "Partners", "Capital", "Bank", "Trust"]
_CITIES = [
    "Springfield", "Riverside", "Fairview", "Georgetown", "Clinton",
    "Salem", "Madison", "Arlington", "Ashland", "Burlington", "Clayton",
    "Dayton", "Dover", "Franklin", "Greenville", "Hamilton", "Hudson",
    "Jackson", "Kingston", "Lexington", "Milton", "Newport", "Oakland",
    "Oxford", "Princeton", "Richmond", "Winchester",
]
_DT = ["the", "a", "an", "this", "that", "its", "their"]
_IN = ["in", "on", "at", "by", "for", "with", "from", "of", "under",
       "over", "after", "before", "during", "against", "through"]
_PRP = ["it", "he", "she", "they", "we", "her"]
_CC = ["and", "but", "or"]


def _plural(n: str) -> str:
    if n.endswith(("s", "x", "ch", "sh")):
        return n + "es"
    if n.endswith("y") and n[-2] not in "aeiou":
        return n[:-1] + "ies"
    return n + "s"


def _third(v: str) -> str:
    return _plural(v)  # same orthography rule


def _past(v: str) -> str:
    if v.endswith("e"):
        return v + "d"
    if v.endswith("y") and v[-2] not in "aeiou":
        return v[:-1] + "ied"
    return v + "ed"


def _gerund(v: str) -> str:
    if v.endswith("e") and v not in ("see", "be"):
        return v[:-1] + "ing"
    return v + "ing"


_IRREGULAR_PAST = {
    "become": "became", "begin": "began", "build": "built", "buy":
    "bought", "cut": "cut", "fall": "fell", "grow": "grew", "hold":
    "held", "keep": "kept", "lead": "led", "leave": "left", "pay":
    "paid", "rise": "rose", "say": "said", "see": "saw", "sell": "sold",
    "send": "sent", "take": "took", "tell": "told", "win": "won",
}


class _PosGrammar:
    """Phrase-structure sampler emitting (token, tag) pairs."""

    def __init__(self, rng: random.Random):
        self.rng = rng

    def np(self) -> Sentence:
        r = self.rng.random()
        out: Sentence = []
        if r < 0.12:
            return [(self.rng.choice(_PRP), "PRP")]
        if r < 0.24:
            # proper noun, possibly two-part
            name = [(self.rng.choice(_FIRST_NAMES), "NNP")]
            if self.rng.random() < 0.5:
                name.append((self.rng.choice(_LAST_NAMES), "NNP"))
            return name
        if r < 0.32:
            n = self.rng.choice(_NOUN_STEMS)
            return [(str(self.rng.randint(2, 900)), "CD"),
                    (_plural(n), "NNS")]
        out.append((self.rng.choice(_DT), "DT"))
        while self.rng.random() < 0.45:
            out.append((self.rng.choice(_ADJ), "JJ"))
            if len(out) > 2:
                break
        n = self.rng.choice(_NOUN_STEMS)
        if self.rng.random() < 0.25:
            out.append((_plural(n), "NNS"))
        else:
            out.append((n, "NN"))
        return out

    def pp(self) -> Sentence:
        return [(self.rng.choice(_IN), "IN")] + self.np()

    def vp(self) -> Sentence:
        v = self.rng.choice(_VERB_STEMS)
        r = self.rng.random()
        out: Sentence = []
        if self.rng.random() < 0.18:
            out.append((self.rng.choice(_ADV), "RB"))
        if r < 0.45:
            out.append((_IRREGULAR_PAST.get(v, _past(v)), "VBD"))
        elif r < 0.8:
            out.append((_third(v), "VBZ"))
        else:
            aux = self.rng.choice(["is", "was"])
            out.append((aux, "VBZ"))
            out.append((_gerund(v), "VBG"))
        out.extend(self.np())
        if self.rng.random() < 0.4:
            out.extend(self.pp())
        return out

    def sentence(self) -> Sentence:
        s = self.np() + self.vp()
        if self.rng.random() < 0.2:
            s += [(",", ","), (self.rng.choice(_CC), "CC")]
            s += self.np() + self.vp()
        elif self.rng.random() < 0.25:
            s += self.pp()
        s.append((".", "."))
        return s


def generate_pos_corpus(n_sentences: int, seed: int = 0) -> List[Sentence]:
    """Deterministic POS corpus; ~11 tokens/sentence, 13 tags."""
    rng = random.Random(seed)
    g = _PosGrammar(rng)
    return [g.sentence() for _ in range(n_sentences)]


def generate_ner_corpus(n_sentences: int, seed: int = 0) -> List[Sentence]:
    """Deterministic BIO-tagged NER corpus (PER/ORG/LOC + O)."""
    rng = random.Random(seed)

    def person() -> Sentence:
        out = [(rng.choice(_FIRST_NAMES), "B-PER")]
        if rng.random() < 0.7:
            out.append((rng.choice(_LAST_NAMES), "I-PER"))
        return out

    def org() -> Sentence:
        out = [(rng.choice(_ORG_HEADS), "B-ORG")]
        if rng.random() < 0.35:
            out.append((rng.choice(_ORG_HEADS), "I-ORG"))
        out.append((rng.choice(_ORG_TAILS), "I-ORG"))
        return out

    def loc() -> Sentence:
        return [(rng.choice(_CITIES), "B-LOC")]

    def o(words: str) -> Sentence:
        return [(w, "O") for w in words.split()]

    templates = [
        lambda: person() + o("joined") + org() + o("in") + loc() + o("."),
        lambda: org() + o("named") + person() + o("as chief executive ."),
        lambda: o("shares of") + org() + o("fell sharply in") + loc()
        + o("trading ."),
        lambda: person() + o("said") + org() + o("would expand its plant"
                                                 " in") + loc() + o("."),
        lambda: o("the") + org() + o("unit in") + loc() + o("reported"
                                                            " higher profit ."),
        lambda: person() + o("and") + person() + o("met officials from")
        + org() + o("."),
        lambda: org() + o("agreed to buy") + org() + o("for 500 million"
                                                       " dollars ."),
        lambda: o("analysts in") + loc() + o("expect") + org()
        + o("to cut costs ."),
        lambda: person() + o("moved from") + loc() + o("to") + loc()
        + o("last year ."),
        lambda: o("the board of") + org() + o("approved the plan ."),
    ]
    return [rng.choice(templates)() for _ in range(n_sentences)]
