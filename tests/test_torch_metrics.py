"""The port's copies of the paper's §4 quality metrics
(``repro_torch.core.metrics``) and its latency model
(``repro_torch.core.latency``) against the JAX package's on the same
inputs: seeded random word lists, the empty cases, and a grid of model
sizes, contexts, outputs and hit rates. Both are plain Python and numpy,
so they agree to 1e-12."""
import dataclasses

import numpy as np
import pytest

from repro.core import latency as JL
from repro.core import metrics as JM
from repro_torch.core import latency as TL
from repro_torch.core import metrics as TM

WORDS = ["aurora", "bridge", "height", "the", "of", "meridian", "canal",
         "founded", "is", "what", "who", "port", "serrano", "x1", "2024"]
EMPTY = [("", ""), ("", "the bridge"), ("the bridge", ""), ("?!", "..."),
         ("?!", "aurora")]


def _texts(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 12))
        out.append(" ".join(rng.choice(WORDS, k)) + rng.choice(["", "?",
                                                               "."]))
    return out


def _pairs(seed):
    a, b = _texts(seed), _texts(seed + 100)
    return list(zip(a, b)) + [(t, t) for t in a[:5]] + EMPTY


@pytest.mark.parametrize("name", ["unigram_f1", "rouge_l_f1",
                                  "bert_score_f1"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_matches_reference(name, seed):
    got = [getattr(TM, name)(p, r) for p, r in _pairs(seed)]
    want = [getattr(JM, name)(p, r) for p, r in _pairs(seed)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert all(0.0 <= x <= 1.0 + 1e-12 for x in got)
    assert getattr(TM, name)("", "") == 1.0
    assert getattr(TM, name)("", "aurora") == 0.0


def test_bert_score_takes_the_ports_hash_embedder():
    from repro.core.embedder import HashEmbedder as JHash
    from repro_torch.core.embedder import HashEmbedder
    for p, r in _pairs(5):
        got = TM.bert_score_f1(p, r, embedder=HashEmbedder(dim=64,
                                                           ngrams=(1, 2)))
        want = JM.bert_score_f1(p, r, embedder=JHash(dim=64, ngrams=(1, 2)))
        assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("name", ["unigram_f1", "rouge_l_f1",
                                  "bert_score_f1"])
def test_corpus_mean_matches_reference(name):
    preds, refs = _texts(7), _texts(8)
    got = TM.corpus_mean(getattr(TM, name), preds, refs)
    want = JM.corpus_mean(getattr(JM, name), preds, refs)
    assert abs(got - want) <= 1e-12


def test_llm_latency_and_effective_latency_match_reference():
    assert dataclasses.asdict(TL.H100) == dataclasses.asdict(JL.H100)
    assert not hasattr(TL, "V5E")       # the port states no TPU point
    for n_params in (1.24e9, 8.03e9, 32.8e9):
        for ctx in (0, 46, 512, 4096):
            for out in (1, 16, 128):
                for db in (2.0, 4.0):
                    got = TL.llm_latency(TL.H100, n_params, ctx, out,
                                         dtype_bytes=db)
                    want = JL.llm_latency(JL.H100, n_params, ctx, out,
                                          dtype_bytes=db)
                    assert got.keys() == want.keys()
                    for k in got:
                        assert abs(got[k] - want[k]) <= 1e-12, (k, got, want)
    for hit in np.linspace(0.0, 1.0, 11):
        for search in (1e-3, 5e-3):
            for llm in (0.5, 3.0):
                assert abs(TL.effective_latency(hit, search, llm)
                           - JL.effective_latency(hit, search, llm)) <= 1e-12


def test_measure_reports_the_reference_keys():
    calls = []
    got = TL.measure(lambda x: calls.append(x), 3, repeat=4, warmup=1)
    assert calls == [3] * 5
    assert set(got) == set(JL.measure(lambda: None, repeat=2, warmup=0))
    assert got["min_s"] <= got["p50_s"] <= got["max_s"]


def test_core_exports_the_metrics_and_the_latency_model():
    import repro_torch.core as core
    assert core.unigram_f1 is TM.unigram_f1
    assert core.effective_latency is TL.effective_latency
    assert core.H100 is TL.H100
