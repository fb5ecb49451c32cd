"""Response-quality metrics (§4): Unigram F1, ROUGE-L F1, BERTScore-proxy
(a copy of the JAX package's ``core/metrics.py``, which imports no JAX;
the port keeps its own so it imports nothing of the reference).

BERTScore-proxy follows the BERTScore recipe (greedy token-level cosine
matching, precision/recall/F1) with our embedder providing the token
vectors — contextual-BERT weights don't ship in this container; the proxy
preserves the metric's structure and relative ordering.
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

_WORDS = re.compile(r"\w+")


def _toks(s: str) -> List[str]:
    return _WORDS.findall(s.lower())


def unigram_f1(pred: str, ref: str) -> float:
    p, r = _toks(pred), _toks(ref)
    if not p or not r:
        return float(p == r)
    common = {}
    for w in p:
        common[w] = common.get(w, 0) + 1
    overlap = 0
    for w in r:
        if common.get(w, 0) > 0:
            overlap += 1
            common[w] -= 1
    if overlap == 0:
        return 0.0
    prec = overlap / len(p)
    rec = overlap / len(r)
    return 2 * prec * rec / (prec + rec)


def _lcs(a: List[str], b: List[str]) -> int:
    la, lb = len(a), len(b)
    dp = np.zeros((la + 1, lb + 1), np.int32)
    for i in range(la):
        for j in range(lb):
            if a[i] == b[j]:
                dp[i + 1, j + 1] = dp[i, j] + 1
            else:
                dp[i + 1, j + 1] = max(dp[i, j + 1], dp[i + 1, j])
    return int(dp[la, lb])


def rouge_l_f1(pred: str, ref: str) -> float:
    p, r = _toks(pred), _toks(ref)
    if not p or not r:
        return float(p == r)
    l = _lcs(p, r)
    if l == 0:
        return 0.0
    prec, rec = l / len(p), l / len(r)
    return 2 * prec * rec / (prec + rec)


def bert_score_f1(pred: str, ref: str, embedder=None) -> float:
    """Greedy-matching token-cosine F1 with hash token embeddings."""
    from repro_torch.core.embedder import HashEmbedder
    embedder = embedder or HashEmbedder(dim=128, ngrams=(1,))
    p, r = _toks(pred), _toks(ref)
    if not p or not r:
        return float(p == r)
    ep = embedder.encode(p)
    er = embedder.encode(r)
    sim = ep @ er.T                                 # (|p|, |r|)
    prec = float(sim.max(axis=1).mean())
    rec = float(sim.max(axis=0).mean())
    if prec + rec <= 0:
        return 0.0
    return 2 * prec * rec / (prec + rec)


def corpus_mean(metric, preds, refs, **kw) -> float:
    return float(np.mean([metric(p, r, **kw) for p, r in zip(preds, refs)]))
