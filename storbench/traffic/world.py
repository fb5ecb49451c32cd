"""The benchmark's world: the store's pairs, the vocabulary and the novel
questions, all drawn from ``--seed`` with the copy of ``core/kb.py``
beside this file.

* The store holds ``n_rows`` distinct anticipated questions, each with its
  fact's answer as the stored response: every fact of a KB profile
  rendered through every plain template and every distinct filler, as the
  offline build anticipates them (the paper's store is 150,000 pairs).
* A novel question asks about an entity the store does not hold. Its
  entity has a fixed number of words and carries a per-request serial, so
  it never repeats, and its token length depends only on the template,
  the filler and the relation's word count: a seed changes which question
  is asked, not how long it is.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from kb import (ENTITIES, FILLERS, HARD_TEMPLATES, PROFILES, RELATIONS,
                TEMPLATES, VALUES, build_kb, render_query)

DISTINCT_FILLERS = list(dict.fromkeys(FILLERS))
# words of no stored entity, so a novel question names a place the store
# does not hold; 32 of each gives 32 ** 4 entities before a serial repeats
NOVEL_ADJ = ["amber", "brisk", "cobalt", "dusky", "elder", "fallow", "gilded",
             "hollow", "ivory", "jagged", "kindred", "lunar", "mossy",
             "narrow", "opal", "pale", "quiet", "russet", "sable", "tawny",
             "umber", "vivid", "wistful", "xeric", "yonder", "zesty",
             "ashen", "briny", "cindered", "dappled", "ebony", "frosted"]
NOVEL_NOUN = ["heron", "quarry", "beacon", "orchard", "bastion", "causeway",
              "foundry", "granary", "hamlet", "inlet", "jetty", "kiln",
              "lagoon", "mill", "nursery", "outpost", "pavilion", "quay",
              "rampart", "spire", "tannery", "bridgehead", "viaduct",
              "wharf", "yard", "ziggurat", "aqueduct", "belfry", "cistern",
              "dovecote", "estuary", "ferry"]
NOVEL_PLACE = ["abbot", "barley", "candle", "drover", "ember", "fennel",
               "garnet", "hazel", "indigo", "juniper", "kestrel", "linden",
               "marrow", "nettle", "osier", "pewter", "quince", "rowan",
               "saffron", "thistle", "upland", "vetch", "willow", "yarrow",
               "zephyr", "alder", "bramble", "clover", "damson", "elm",
               "furze", "gorse"]
RELATIONS_BY_WORDS = {n: [r for r in RELATIONS if len(r.split()) == n]
                      for n in sorted({len(r.split()) for r in RELATIONS})}


def novel_entity(serial: int) -> str:
    """The entity of novel request ``serial``: eight words, unique per
    serial below 32 ** 4."""
    a, b, c, d = (serial // 32 ** i % 32 for i in range(4))
    return (f"the {NOVEL_ADJ[a]} {NOVEL_NOUN[b]} of the {NOVEL_PLACE[c]} "
            f"{NOVEL_PLACE[d]} reach")


def novel_question(kind: str, template: int, filler: int, relation: str,
                   serial: int) -> str:
    e = novel_entity(serial)
    if kind == "hard":
        return HARD_TEMPLATES[template].format(r=relation, e=e)
    return DISTINCT_FILLERS[filler] + TEMPLATES[template].format(r=relation,
                                                                e=e)


def store_pairs(profile: str, n_rows: int, seed: int
                ) -> Tuple[List[str], List[str]]:
    """``n_rows`` distinct (question, stored response) pairs: the facts of
    ``profile``'s KB in order, each through every plain template and every
    distinct filler."""
    per_fact = len(TEMPLATES) * len(DISTINCT_FILLERS)
    n_docs = math.ceil(n_rows / per_fact / PROFILES[profile]["facts_per_doc"]
                       * 1.05) + 1
    kb = build_kb(profile, seed=seed, n_docs=n_docs)
    questions, answers, seen = [], [], set()
    for f in kb.facts:
        for t in range(len(TEMPLATES)):
            for fi in range(len(DISTINCT_FILLERS)):
                q = render_query(f, t, FILLERS.index(DISTINCT_FILLERS[fi]))
                if q in seen:
                    continue
                seen.add(q)
                questions.append(q)
                answers.append(f.answer())
                if len(questions) == n_rows:
                    return questions, answers
    raise ValueError(f"the {profile} KB of {n_docs} docs holds only "
                     f"{len(questions)} distinct questions")


def vocabulary_corpus(profile: str, n_rows: int) -> List[str]:
    """Texts whose words make the tokenizer's vocabulary: every word a
    stored pair or a novel question can hold, so that no prompt falls back
    to bytes (a deployment's tokenizer knows its domain's words)."""
    per_fact = len(TEMPLATES) * len(DISTINCT_FILLERS)
    n_docs = math.ceil(n_rows / per_fact / PROFILES[profile]["facts_per_doc"]
                       * 1.05) + 1
    texts = [f"{e} of district {d}" for d in range(n_docs) for e in ENTITIES]
    texts += RELATIONS + VALUES + FILLERS + [
        t.format(r="", e="") for t in TEMPLATES + HARD_TEMPLATES]
    texts += [" ".join(NOVEL_ADJ + NOVEL_NOUN + NOVEL_PLACE),
              "the of is reach"]
    return texts


def zipf_rows(n_rows: int, a: float, n: int, rng: np.random.Generator
              ) -> np.ndarray:
    """``n`` stored rows drawn by Zipf popularity (rank r has weight
    (r + 1) ** -a) over a seeded ranking of the rows."""
    rank = rng.permutation(n_rows)
    p = (rank + 1.0) ** -a
    p /= p.sum()
    return rng.choice(n_rows, size=n, p=p)


def spread_quantiles(lo: float, hi: float, n: int) -> List[int]:
    """``n`` values at the mid-quantiles of the log-uniform law on
    [lo, hi]: the same multiset for every seed."""
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def novel_specs(profile: str, n: int) -> List[Tuple[str, int, int, int]]:
    """``n`` (kind, template, filler, relation words) of novel questions
    drawn once by ``profile``'s hard share and template skew from a fixed
    seed: every run's seed permutes this one list, so every seed sends the
    same prompt lengths."""
    prof = PROFILES[profile]
    rng = np.random.default_rng(20250919)
    tp = np.arange(1, len(TEMPLATES) + 1, dtype=np.float64) \
        ** -prof["template_skew"]
    tp /= tp.sum()
    words = sorted(RELATIONS_BY_WORDS)
    wp = np.array([len(RELATIONS_BY_WORDS[w]) for w in words], np.float64)
    wp /= wp.sum()
    out = []
    for _ in range(n):
        w = int(rng.choice(words, p=wp))
        if rng.random() < prof["hard_frac"]:
            out.append(("hard", int(rng.choice(len(HARD_TEMPLATES))), 0, w))
        else:
            out.append(("plain", int(rng.choice(len(TEMPLATES), p=tp)),
                        int(rng.choice(len(DISTINCT_FILLERS))), w))
    return out


def relation_of(words: int, rng: np.random.Generator) -> str:
    choices: Sequence[str] = RELATIONS_BY_WORDS[words]
    return choices[int(rng.integers(len(choices)))]
