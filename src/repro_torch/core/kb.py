"""Synthetic knowledge bases + user-query distributions.

(A copy of the JAX package's ``core/kb.py``.) No QA datasets ship with
this repo, so the paper's SQuAD / NarrativeQA /
TriviaQA setups are reproduced as three synthetic KB profiles matching their
salient statistics for this system: context length per document (drives LLM
inference latency in Fig 3) and query predictability (drives hit rate in
Table 1 — SQuAD-like short factoid questions are most predictable,
TriviaQA-like trivia the least).

A KB is a set of documents; each document is a set of (entity, relation,
value) facts rendered to text. USER queries are drawn from a Zipf
distribution over facts x a paraphrase-template distribution + filler noise
— the "narrow or predictable query distribution" regime the paper targets
(§1). The offline generator sees the DOCUMENTS (not the user queries); its
job is to anticipate them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

ENTITIES = [
    "aurora bridge", "cedar falls", "doctor reyes", "the meridian institute",
    "lake halcyon", "professor tanaka", "the obsidian archive",
    "mount caldera", "the verdant coast", "captain ibarra", "new alexandria",
    "the silk consortium", "general okafor", "the amber accord",
    "port serrano", "the lumen foundry", "queen adelheid", "the iron canal",
    "senator volkov", "the coral senate", "engineer dubois",
    "the basalt citadel", "admiral chen", "the golden meridian",
    "judge okonkwo", "the crystal parliament", "bishop armand",
    "the copper exchange", "warden silva", "the azure expedition",
]
RELATIONS = [
    "height", "founder", "population", "construction year", "length",
    "capital", "author", "discovery date", "budget", "location", "leader",
    "purpose", "successor", "native language", "main export", "area",
    "chief rival", "founding charter", "patron", "climate",
]
VALUES = [
    "two hundred meters", "elena marchetti", "forty thousand", "1887",
    "twelve kilometers", "the northern quarter", "hassan el-badri", "1923",
    "nine million crowns", "the western escarpment", "director yuen",
    "flood control", "the second assembly", "old vareni", "refined cobalt",
    "three hundred hectares", "the harbor league", "the spring covenant",
    "the mercantile guild", "cool and wet",
]

# paraphrase templates for factoid questions about (entity, relation)
TEMPLATES = [
    "what is the {r} of {e}?",
    "tell me the {r} of {e}",
    "what's {e}'s {r}?",
    "do you know the {r} of {e}?",
    "i want to know the {r} of {e}",
    "can you give me {e}'s {r}?",
    "{e} {r}?",
    "please state the {r} of {e}",
    "what would be the {r} of {e}",
    "give the {r} for {e}",
]
# phrasings the offline generator does NOT anticipate — the miss mass that
# bounds achievable hit rate (real users paraphrase beyond any precomputed
# set; the per-dataset fraction models SQuAD < NarrativeQA < TriviaQA
# predictability, Table 1).
HARD_TEMPLATES = [
    "regarding {e}, i could use some information on its {r}",
    "been curious lately about how the {r} works out for {e}",
    "my colleague asked me yesterday about {e} and specifically the {r}",
    "if you had to look it up, where does {e} stand on {r}",
    "summarize whatever records exist concerning the {r} associated with "
    "{e}",
    "in the grand scheme of things, how should one think about {e} and "
    "its {r}",
]
FILLERS = ["", "", "", "hi, ", "hello, ", "quick question: ", "hey — ",
           "sorry to bother you, but "]


@dataclasses.dataclass
class Fact:
    entity: str
    relation: str
    value: str
    doc_id: int

    def statement(self) -> str:
        return f"the {self.relation} of {self.entity} is {self.value}."

    def answer(self) -> str:
        return (f"the {self.relation} of {self.entity} is {self.value}.")


@dataclasses.dataclass
class Document:
    doc_id: int
    facts: List[Fact]
    context_pad: int  # extra narrative tokens (dataset context length knob)

    def text(self) -> str:
        body = " ".join(f.statement() for f in self.facts)
        pad = " ".join(["the chronicle further records details"]
                       * max(self.context_pad // 5, 0))
        return (body + " " + pad).strip()


@dataclasses.dataclass
class KB:
    name: str
    docs: List[Document]
    facts: List[Fact]
    zipf_a: float          # user-query skew (lower = flatter = harder)
    template_skew: float   # concentration of paraphrase choice
    popularity: "np.ndarray" = None  # rank of each fact in the user Zipf
    hard_frac: float = 0.0           # unanticipatable-phrasing mass

    def doc_text(self, doc_id: int) -> str:
        return self.docs[doc_id].text()


# Dataset profiles: (docs, facts/doc, context pad tokens, zipf, tmpl skew,
# hard_frac = probability a user query uses an unanticipatable phrasing).
# Context pads mirror the relative context sizes of the paper's datasets
# (SQuAD short paragraphs < NarrativeQA summaries < TriviaQA evidence).
PROFILES = {
    "squad": dict(n_docs=200, facts_per_doc=8, context_pad=60,
                  zipf_a=1.3, template_skew=1.5, hard_frac=0.55),
    "narrativeqa": dict(n_docs=200, facts_per_doc=12, context_pad=400,
                        zipf_a=1.1, template_skew=1.0, hard_frac=0.75),
    "triviaqa": dict(n_docs=200, facts_per_doc=16, context_pad=1200,
                     zipf_a=0.9, template_skew=0.6, hard_frac=0.85),
}


def build_kb(name: str, seed: int = 0, n_docs: Optional[int] = None) -> KB:
    prof = PROFILES[name]
    # zlib.crc32, NOT hash(): python string hashing is randomized per
    # process, which would give every process a different "world" and
    # silently invalidate cross-process store caches.
    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    n_docs = n_docs or prof["n_docs"]
    docs, facts = [], []
    for d in range(n_docs):
        fs = []
        for _ in range(prof["facts_per_doc"]):
            f = Fact(entity=rng.choice(ENTITIES) + f" of district {d}",
                     relation=str(rng.choice(RELATIONS)),
                     value=str(rng.choice(VALUES)),
                     doc_id=d)
            fs.append(f)
            facts.append(f)
        docs.append(Document(d, fs, prof["context_pad"]))
    # fact popularity (user-query Zipf rank) is a property of the WORLD:
    # both the online user stream and a well-prompted generator LLM see the
    # same salience ordering — the "predictable query distribution" premise
    # (paper §1). rank[i] = Zipf rank of fact i.
    rank = rng.permutation(n_docs * prof["facts_per_doc"])
    return KB(name, docs, facts, prof["zipf_a"], prof["template_skew"],
              popularity=rank, hard_frac=prof["hard_frac"])


def render_query(fact: Fact, template_id: int, filler_id: int = 0) -> str:
    t = TEMPLATES[template_id % len(TEMPLATES)]
    return (FILLERS[filler_id % len(FILLERS)]
            + t.format(r=fact.relation, e=fact.entity))


def sample_user_queries(kb: KB, n: int, seed: int = 1):
    """The ONLINE query stream: Zipf over facts x skewed template choice.

    Returns list of (query_text, fact) — fact is the gold reference for
    quality metrics.
    """
    rng = np.random.default_rng(seed)
    nf = len(kb.facts)
    p = (kb.popularity + 1.0) ** -kb.zipf_a       # P(fact i) by its rank
    p /= p.sum()
    tp = np.arange(1, len(TEMPLATES) + 1, dtype=np.float64) \
        ** -kb.template_skew
    tp /= tp.sum()
    out = []
    for _ in range(n):
        f = kb.facts[rng.choice(nf, p=p)]
        if rng.random() < kb.hard_frac:
            t = rng.choice(len(HARD_TEMPLATES))
            q = HARD_TEMPLATES[t].format(r=f.relation, e=f.entity)
        else:
            t = rng.choice(len(TEMPLATES), p=tp)
            q = render_query(f, t, int(rng.choice(len(FILLERS))))
        out.append((q, f))
    return out
