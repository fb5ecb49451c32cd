"""Deduplicated query generation (§3.2): the paper's Generator (a copy of
the JAX package's ``core/generator.py``; pure numpy, nothing runs on a
device).

Two techniques, implemented exactly as described:

* **Adaptive Query Masking** — recently generated queries are injected back
  into the generation context. Candidates are taken most-recent-first,
  tokenized, and included only if the WHOLE query fits the remaining token
  budget ``max_ctx - len(chunk) - len(scaffold)``.

* **Adaptive Sampling** — a candidate whose embedding similarity to any
  stored query reaches ``S_th_Gen`` (paper: 0.99) is DISCARDED, and the
  generation temperature steps +0.1 (from 0.7 up to 1.0) to push the next
  samples toward diversity. (The paper increases monotonically on each
  collision; we follow that, tracked per knowledge chunk.)

The LLM behind generation is pluggable:
  * ``SyntheticOracleLM`` — a knowledge-grounded query synthesizer with a
    real temperature-controlled sampling distribution over (fact, template,
    filler) — semantically meaningful queries without pretrained weights,
    used for the paper-reproduction benchmarks.
  * ``TorchLM`` (repro_torch.serving.lm) — an actual LM driven through the
    port's serving engine (prompt -> sample -> detokenize); mechanically
    identical path, used to prove the plumbing is LLM-real.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.kb import KB, TEMPLATES, FILLERS, render_query


@dataclasses.dataclass
class GenCfg:
    s_th_gen: float = 0.99
    temp0: float = 0.7
    temp_step: float = 0.1
    temp_max: float = 1.0
    max_ctx: int = 512            # generator LM context length (tokens)
    scaffold_tokens: int = 32     # prompt scaffolding budget
    dedup: bool = True            # False = the paper's "Random" baseline
    mask_recent: int = 64         # masking candidate pool (most recent)


class QueryLM(Protocol):
    def generate_query(self, chunk_text: str, masked: Sequence[str],
                       temperature: float, rng) -> str: ...

    def answer(self, query: str, chunk_text: str) -> str: ...


class SyntheticOracleLM:
    """Knowledge-grounded generator with temperature-controlled diversity.

    Models an LLM prompted to "ask questions a user would ask about this
    document": at the default temperature (0.7) its (fact, template)
    distribution matches the user-query distribution shape (the paper's
    predictable-queries premise) — so low temperature re-samples popular
    combos (many near-duplicates, the regime adaptive sampling fights) and
    HIGHER temperature flattens the same distribution (on-distribution
    diversity, not noise). Filler phrasing is sampled like users do,
    independent of temperature. Masked queries are avoided (an
    instruction-following LLM told "don't repeat these").
    """

    def __init__(self, kb: KB, quality: str = "8b"):
        self.kb = kb
        self.quality = quality
        self._doc_facts = {d.doc_id: d.facts for d in kb.docs}
        # per-doc base log-probs from the shared popularity ranks
        self._doc_logp = {}
        fact_index = {id(f): i for i, f in enumerate(kb.facts)}
        for d in kb.docs:
            ranks = np.asarray([kb.popularity[fact_index[id(f)]]
                                for f in d.facts], np.float64)
            self._doc_logp[d.doc_id] = -kb.zipf_a * np.log(ranks + 1.0)
        self._t_logp = -kb.template_skew * np.log(
            np.arange(1, len(TEMPLATES) + 1, dtype=np.float64))

    def generate_query(self, chunk_text, masked, temperature, rng):
        doc_id = int(chunk_text.split("\x00", 1)[0])  # chunk key prefix
        facts = self._doc_facts[doc_id]
        t_eff = max(temperature, 0.05) / 0.7   # temp0 == user distribution
        pf = np.exp(self._doc_logp[doc_id] / t_eff)
        pf /= pf.sum()
        pt = np.exp(self._t_logp / t_eff)
        pt /= pt.sum()
        masked_set = set(masked)
        for _ in range(8):  # the LLM "tries again" within one call
            f = facts[rng.choice(len(facts), p=pf)]
            t = int(rng.choice(len(TEMPLATES), p=pt))
            fill = int(rng.choice(len(FILLERS)))
            q = render_query(f, t, fill)
            if q not in masked_set:
                return q
        return q

    def answer(self, query, chunk_text):
        doc_id = int(chunk_text.split("\x00", 1)[0])
        best, score = None, -1
        qw = set(query.lower().split())
        for f in self._doc_facts[doc_id]:
            s = len(qw & set((f.entity + " " + f.relation).split()))
            if s > score:
                best, score = f, s
        if self.quality == "8b":
            return best.answer()
        # "1b" degraded responder: terse, sometimes drops the value detail
        return f"{best.relation}: {best.value.split()[0]}"


def chunk_key(doc_id: int, text: str) -> str:
    """Chunks carry their doc id so oracle LMs can ground answers."""
    return f"{doc_id}\x00{text}"


@dataclasses.dataclass
class GenStats:
    generated: int = 0
    discarded: int = 0
    seconds: float = 0.0
    max_pair_seconds: float = 0.0
    temp_final: float = 0.0


def masked_for_chunk(tok, cfg: GenCfg, recent: Sequence[str],
                     chunk_text: str) -> List[str]:
    """Adaptive query masking (§3.2): most-recent-first prior queries that
    fit WHOLE in the remaining context budget. Shared by the sequential
    generator and the batched precompute pipeline so their masking
    semantics cannot drift apart."""
    budget = cfg.max_ctx - tok.count(chunk_text) - cfg.scaffold_tokens
    chosen = []
    for q in reversed(recent[-cfg.mask_recent:]):
        n = tok.count(q)
        if n <= budget:              # only COMPLETE prior queries
            chosen.append(q)
            budget -= n
        # (queries that don't fit are skipped, not truncated)
    return chosen


class QueryGenerator:
    """Drives a QueryLM over a knowledge base into a store/index.

    This is the paper's strictly sequential loop — one candidate, one
    ``embedder.encode`` call, one dense dedup scan per step — kept as the
    semantic reference and benchmark baseline. The production offline path
    is ``repro_torch.core.precompute.PrecomputePipeline``, which batches the
    embed + dedup across a wave of candidates (>= 3x pairs/sec at wave 32;
    identical semantics at wave 1).
    """

    def __init__(self, lm: QueryLM, embedder, tokenizer, cfg: GenCfg = None):
        self.lm = lm
        self.embedder = embedder
        self.tok = tokenizer
        self.cfg = cfg or GenCfg()

    # -- adaptive query masking --------------------------------------------
    def select_masked(self, recent: List[str], chunk_text: str) -> List[str]:
        return masked_for_chunk(self.tok, self.cfg, recent, chunk_text)

    # -- main loop ------------------------------------------------------------
    def generate(self, chunks: Sequence[str], n_target: int, *, seed=0,
                 store=None, on_pair=None) -> Tuple[List[str], List[str],
                                                    np.ndarray, GenStats]:
        """Generate up to ``n_target`` accepted (query, response) pairs.

        Returns (queries, responses, embeddings, stats). ``store`` (a
        PrecomputedStore) receives batches as they accept; ``on_pair`` is an
        optional callback(query, response).
        """
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        queries: List[str] = []
        responses: List[str] = []
        embs: List[np.ndarray] = []
        emb_mat: Optional[np.ndarray] = None
        temps = {i: cfg.temp0 for i in range(len(chunks))}
        recent: List[str] = []
        stats = GenStats()
        t_start = time.perf_counter()
        ci = 0
        attempts = 0
        max_attempts = n_target * 20 + 100

        while len(queries) < n_target and attempts < max_attempts:
            attempts += 1
            t0 = time.perf_counter()
            chunk = chunks[ci % len(chunks)]
            ci += 1
            masked = self.select_masked(recent, chunk) if cfg.dedup else []
            temp = temps[(ci - 1) % len(chunks)] if cfg.dedup else cfg.temp0
            q = self.lm.generate_query(chunk, masked, temp, rng)
            e = self.embedder.encode([q])[0]
            if cfg.dedup and emb_mat is not None and len(emb_mat):
                sim = float(np.max(emb_mat @ e))
                if sim >= cfg.s_th_gen:
                    stats.discarded += 1
                    # adaptive sampling: bump temperature, discard
                    key = (ci - 1) % len(chunks)
                    temps[key] = min(temps[key] + cfg.temp_step,
                                     cfg.temp_max)
                    recent.append(q)   # mask it so the LM avoids it next
                    stats.max_pair_seconds = max(
                        stats.max_pair_seconds, time.perf_counter() - t0)
                    continue
            r = self.lm.answer(q, chunk)
            queries.append(q)
            responses.append(r)
            embs.append(e)
            recent.append(q)
            if emb_mat is None:
                emb_mat = e[None, :].copy()
            else:
                emb_mat = np.concatenate([emb_mat, e[None, :]], axis=0)
            if store is not None:
                store.add_batch(e[None, :], [q], [r])
            if on_pair:
                on_pair(q, r)
            stats.generated += 1
            stats.max_pair_seconds = max(stats.max_pair_seconds,
                                         time.perf_counter() - t0)
        stats.seconds = time.perf_counter() - t_start
        stats.temp_final = max(temps.values()) if temps else cfg.temp0
        emb_out = (np.stack(embs) if embs
                   else np.zeros((0, getattr(self.embedder, "dim", 384)),
                                 np.float32))
        return queries, responses, emb_out, stats
