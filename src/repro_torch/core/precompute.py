"""Batched, resumable offline precompute pipeline (§3.2/§3.3 at paper scale;
the port of the JAX package's ``core/precompute.py``, with the dedup index
on a device).

The paper's headline artifact is an offline-generated store of 150K
deduplicated (query, response) pairs. The sequential reference loop
(``repro_torch.core.generator.QueryGenerator``) cannot reach that scale in
reasonable time: one ``embedder.encode`` call per candidate and an O(N)
dense dedup scan that re-concatenates the whole embedding matrix on every
accept. This pipeline keeps the paper's semantics — adaptive query masking
and adaptive sampling, per knowledge chunk — and restructures the loop
around waves:

* **Wave generation** — W candidates are drawn per step, round-robin
  across KB chunks, each against its chunk's current temperature and the
  wave-start mask set.
* **Batched embedding** — one ``embedder.encode`` call per wave.
* **Index-backed dedup** — the wave is scored against an
  ``IncrementalIndex`` on the pipeline's ``device`` (flat buffer below the
  tier boundary, IVF with assign-to-nearest-centroid appends above it)
  instead of the quadratic matrix scan; wave-internal collisions are
  discarded too, via the wave's Gram matrix (on the host, as the
  reference computes it).
* **Checkpointed builds** — generator state (per-chunk temperatures, the
  recent-mask ring, the RNG bit-generator state, the chunk cursor and
  attempt/wave counters) is written into the store manifest at every
  checkpoint, so a killed build resumes where it stopped and — because the
  dedup index rebuild and the wave schedule are deterministic — produces a
  store byte-identical to an uninterrupted run.

At ``wave=1`` the pipeline reproduces the sequential generator exactly —
same RNG stream, same accept/discard decisions — when the dedup dtype
matches (store-free runs, or a float32 store; tests pin that
equivalence). At larger waves the semantics differ only in visibility:
the W candidates of one wave are generated against the same wave-start
state, so they cannot see each other in the mask set (their collisions
are still caught by the Gram check).

Dedup similarities are computed on embeddings round-tripped through the
store dtype (``store.roundtrip_dtype`` — float16 by default, symmetric
per-row int8 quantize/dequantize for ``emb_dtype="int8"``): an
uninterrupted run and a resumed run (which rebuilds its dedup index from
the store's own shards) then see bit-identical similarity scores — with
raw float32 the two could disagree on candidates sitting exactly at the
0.99 threshold. The flip side: with a narrowed store dtype the pipeline's
accept/discard decisions can in principle differ from the raw-float32
sequential generator for candidates straddling the threshold under one
rounding but not the other.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.generator import GenCfg, QueryLM, masked_for_chunk
from repro_torch.core.index import (FLAT_MAX_ROWS, IncrementalIndex,
                                    exact_fp32)
from repro_torch.core.store import roundtrip_dtype

STATE_KEY = "gen_state"
STATE_VERSION = 1


class BuildKilled(RuntimeError):
    """Raised by the test/bench hook that simulates a killed build."""


def chunks_digest(chunks: Sequence[str]) -> int:
    """Content digest of the chunk sequence: resuming against a different
    KB (seed, dataset, doc set) must fail loudly, not splice two worlds
    into one store — the chunk COUNT alone cannot tell them apart."""
    h = 0
    for c in chunks:
        h = zlib.crc32(c.encode("utf-8"), h)
    return h


@dataclasses.dataclass
class PrecomputeCfg:
    wave: int = 32                 # candidates per step (W)
    checkpoint_every: int = 64     # waves between flush + state checkpoint
    flat_max_rows: int = FLAT_MAX_ROWS   # dedup-index tier boundary
    background_recluster: bool = False   # IVF refits in a thread (faster,
    #                                      gives up resume determinism)
    max_attempts_factor: int = 20  # attempts cap = factor*n_target + 100


@dataclasses.dataclass
class PrecomputeStats:
    generated: int = 0             # rows accepted by THIS run
    discarded: int = 0             # candidates discarded by THIS run
    seconds: float = 0.0           # cumulative build seconds (incl. any
    #                                killed prefix this run resumed)
    run_seconds: float = 0.0       # wall-clock of THIS run only
    waves: int = 0
    max_wave_seconds: float = 0.0
    temp_final: float = 0.0
    resumed_rows: int = 0          # rows already in the store at start
    index_mode: str = "flat"       # dedup index tier at end of run
    refits: int = 0                # dedup index k-means refits this run
    refit_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def pairs_per_sec(self) -> float:
        """This run's throughput (resumed prefixes excluded on both
        sides of the division)."""
        return self.generated / self.run_seconds if self.run_seconds \
            else 0.0


class PrecomputePipeline:
    """Drives a QueryLM over KB chunks into a store, W candidates at a time.

    ``run`` mirrors ``QueryGenerator.generate``'s contract — returns
    ``(queries, responses, embeddings, stats)`` for the rows accepted by
    THIS run (a resumed run returns only its continuation) and streams
    accepted rows into ``store`` as it goes. The dedup index lives on
    ``device`` ("cuda" unless the caller passes "cpu"); the checkpoint
    does not depend on it, so a build resumes on either device and in
    either package.
    """

    def __init__(self, lm: QueryLM, embedder, tokenizer,
                 gen_cfg: GenCfg = None, cfg: PrecomputeCfg = None,
                 device="cuda"):
        self.lm = lm
        self.embedder = embedder
        self.tok = tokenizer
        self.gen_cfg = gen_cfg or GenCfg()
        self.cfg = cfg or PrecomputeCfg()
        self.device = device

    # -- checkpoint state -----------------------------------------------------
    def _config_sig(self) -> dict:
        """Everything besides the chunks that changes what rows a build
        produces: the embedder identity (resuming a hash-embedded store
        with a neural encoder would splice two embedding spaces into one
        index), the generation config, and the checkpoint cadence (it
        sets the flush schedule the byte-identity guarantee replays)."""
        return {
            "embedder": type(self.embedder).__name__,
            "dim": int(getattr(self.embedder, "dim", 384)),
            "checkpoint_every": self.cfg.checkpoint_every,
            "gen": dataclasses.asdict(self.gen_cfg),
        }

    def _capture_state(self, digest, rng, temps, recent, ci, attempts,
                       waves, generated, discarded, elapsed) -> dict:
        g = self.gen_cfg
        return {
            "version": STATE_VERSION,
            "wave": self.cfg.wave,
            "chunks_digest": digest,
            "config": self._config_sig(),
            "n_chunks": len(temps),
            "temps": [float(t) for t in temps],
            # only the tail the masker can ever read (the "recent ring")
            "recent": list(recent[-g.mask_recent:]),
            "ci": ci, "attempts": attempts, "waves": waves,
            "generated": generated, "discarded": discarded,
            "elapsed": elapsed,
            "rng_state": rng.bit_generator.state,
        }

    def _checkpoint(self, store, state: dict):
        store.manifest_extra[STATE_KEY] = state
        store.flush()

    # -- main loop ------------------------------------------------------------
    def run(self, chunks: Sequence[str], n_target: int, *, store=None,
            seed: int = 0, resume: bool = True,
            on_wave: Optional[Callable] = None,
            _kill_after_waves: Optional[int] = None
            ) -> Tuple[List[str], List[str], np.ndarray, PrecomputeStats]:
        g, cfg = self.gen_cfg, self.cfg
        if str(self.device).startswith("cuda"):
            exact_fp32()
        n_chunks = len(chunks)
        store_dtype = np.dtype(store.emb_dtype) if store is not None \
            else np.dtype(np.float32)

        digest = chunks_digest(chunks)
        state = None
        if store is not None and resume:
            state = store.manifest_extra.get(STATE_KEY)
        if state is not None:
            if state["n_chunks"] != n_chunks:
                raise ValueError(
                    f"checkpoint was built over {state['n_chunks']} chunks, "
                    f"got {n_chunks}: refusing to resume")
            if state.get("chunks_digest") != digest:
                raise ValueError(
                    "checkpoint was built over DIFFERENT chunk contents "
                    "(another KB seed/dataset/doc set): refusing to splice "
                    "two corpora into one store")
            sig = self._config_sig()
            if state.get("config") != sig:
                diff = {k for k in sig
                        if state.get("config", {}).get(k) != sig[k]}
                raise ValueError(
                    f"checkpoint was built with different {sorted(diff)} "
                    "(embedder/generation config/checkpoint cadence): "
                    "refusing to resume with mismatched settings")
            if state["wave"] != cfg.wave:
                raise ValueError(
                    f"checkpoint used wave={state['wave']}, got {cfg.wave}: "
                    "resume determinism requires the same wave size")
            if state["generated"] != store.count:
                raise ValueError(
                    f"checkpoint says {state['generated']} rows but store "
                    f"has {store.count}: store was modified outside the "
                    "pipeline")
            rng = np.random.default_rng()
            rng.bit_generator.state = state["rng_state"]
            temps = list(state["temps"])
            recent = list(state["recent"])
            ci, attempts = state["ci"], state["attempts"]
            waves = state["waves"]
            generated, discarded = state["generated"], state["discarded"]
            elapsed_prior = state["elapsed"]
        else:
            if store is not None and store.count:
                raise ValueError(
                    f"store already holds {store.count} rows but carries no "
                    "pipeline checkpoint — it was not built by this "
                    "pipeline and cannot be resumed; use a fresh directory")
            rng = np.random.default_rng(seed)
            temps = [g.temp0] * n_chunks
            recent = []
            ci = attempts = waves = generated = discarded = 0
            elapsed_prior = 0.0

        stats = PrecomputeStats(resumed_rows=generated)
        index = IncrementalIndex(
            getattr(self.embedder, "dim", 384),
            flat_max_rows=cfg.flat_max_rows,
            background=cfg.background_recluster,
            device=self.device) if g.dedup else None
        if index is not None and store is not None and store.count:
            # rebuild the dedup index from the store's own shards: the
            # float16 round-trip makes the rebuilt scores bit-identical to
            # the in-run ones, and the deterministic refit thresholds make
            # the IVF state independent of shard batching
            for shard in store.embeddings().iter_shards():
                index.add(np.asarray(shard, np.float32))

        out_q: List[str] = []
        out_r: List[str] = []
        out_e: List[np.ndarray] = []
        max_attempts = n_target * cfg.max_attempts_factor + 100
        t_start = time.perf_counter()
        waves_this_run = 0

        while generated < n_target and attempts < max_attempts:
            t0 = time.perf_counter()
            w = min(cfg.wave, max_attempts - attempts)
            # 1. wave generation: W candidates against wave-start state
            idxs, qs = [], []
            for j in range(w):
                k = (ci + j) % n_chunks
                chunk = chunks[k]
                masked = masked_for_chunk(self.tok, g, recent, chunk) \
                    if g.dedup else []
                temp = temps[k] if g.dedup else g.temp0
                qs.append(self.lm.generate_query(chunk, masked, temp, rng))
                idxs.append(k)
            ci += w
            attempts += w
            # 2. one embedding batch per wave
            E = np.asarray(self.embedder.encode(qs), np.float32)
            Ed = roundtrip_dtype(E, store_dtype)
            # 3. index-backed dedup + wave-internal Gram check
            if index is not None and len(index):
                base = index.max_sim(Ed)
            else:
                base = np.full(w, -np.inf, np.float32)
            accepted: List[int] = []
            acc_q: List[str] = []
            acc_r: List[str] = []
            for j in range(w):
                if generated >= n_target:
                    break            # target hit mid-wave: drop the tail
                sim = float(base[j])
                if g.dedup and accepted:
                    sim = max(sim, float(np.max(Ed[accepted] @ Ed[j])))
                if g.dedup and sim >= g.s_th_gen:
                    discarded += 1
                    stats.discarded += 1
                    # adaptive sampling: bump this chunk's temperature
                    temps[idxs[j]] = min(temps[idxs[j]] + g.temp_step,
                                         g.temp_max)
                    recent.append(qs[j])
                    continue
                acc_q.append(qs[j])
                acc_r.append(self.lm.answer(qs[j], chunks[idxs[j]]))
                recent.append(qs[j])
                accepted.append(j)
                generated += 1
                stats.generated += 1
            waves += 1
            waves_this_run += 1
            if len(recent) > g.mask_recent:
                recent = recent[-g.mask_recent:]
            if accepted:
                if index is not None:
                    index.add(Ed[accepted])
                if store is not None:
                    store.add_batch(E[accepted], acc_q, acc_r)
                out_q.extend(acc_q)
                out_r.extend(acc_r)
                out_e.append(E[accepted])
            stats.max_wave_seconds = max(stats.max_wave_seconds,
                                         time.perf_counter() - t0)
            if on_wave is not None:
                on_wave(waves, generated, discarded,
                        index.mode if index is not None else "off")
            if (_kill_after_waves is not None
                    and waves_this_run >= _kill_after_waves):
                raise BuildKilled(f"killed after {waves_this_run} waves")
            if store is not None and waves % cfg.checkpoint_every == 0:
                self._checkpoint(store, self._capture_state(
                    digest, rng, temps, recent, ci, attempts, waves,
                    generated, discarded,
                    elapsed_prior + time.perf_counter() - t_start))

        if index is not None:
            index.drain()
            stats.index_mode = index.mode
            stats.refits = index.refits
            stats.refit_seconds = list(index.refit_seconds)
        stats.waves = waves_this_run
        stats.run_seconds = time.perf_counter() - t_start
        stats.seconds = elapsed_prior + stats.run_seconds
        stats.temp_final = max(temps) if temps else g.temp0
        if store is not None:
            self._checkpoint(store, self._capture_state(
                digest, rng, temps, recent, ci, attempts, waves, generated,
                discarded, stats.seconds))
        emb_out = (np.concatenate(out_e, axis=0) if out_e
                   else np.zeros((0, getattr(self.embedder, "dim", 384)),
                                 np.float32))
        return out_q, out_r, emb_out, stats
