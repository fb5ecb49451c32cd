"""StorInfer Runtime (§3.4, Fig 2): parallel vector search + LLM inference
with hit-cancellation (port of the JAX package's ``core/runtime.py``; the
race itself is framework-free, the index and engine are the port's).

On each query the runtime concurrently
  (a) embeds the query and searches the precomputed store (CPU/storage
      resources — a thread here; a dedicated mesh slice at pod scale), and
  (b) starts LLM inference (chunked decode on the accelerator).
If (a) returns a match with similarity >= S_th_Run, the stored response is
returned immediately and a termination signal cancels (b) at the next chunk
boundary — a miss therefore costs exactly the plain-LLM latency (the decode
ran unimpeded the whole time).

Two runtimes share that structure:

  StorInferRuntime — the paper's one-query-at-a-time race (kept as the
      reference implementation and the sequential benchmark baseline).
  BatchedRuntime   — the serving path. Its async front door
      (``serve``/``submit``) is the stage-decoupled
      ``serving.scheduler.ServingPipeline``: admit → embed+search →
      hit-resolve → decode → write-back, each stage its own worker behind
      a bounded queue. Hits resolve the moment the MIPS search returns;
      misses flow into one persistent continuous-batching
      ``BatchScheduler`` whose freed slots are refilled between waves;
      §3.1 ``add_misses`` write-back + ``flush_and_rebuild`` run off the
      critical path with the index swapped atomically. ``query_batch``
      stays as the synchronous compatibility path over the same stage
      helpers (one embed + one MIPS dispatch + one batched decode racing
      it, hit slots cancelled mid-flight).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence, Union


@dataclasses.dataclass
class QueryResult:
    response: str
    source: str               # "store" | "llm"
    hit: bool
    score: float
    matched_query: Optional[str]
    search_s: float
    llm_s: float
    latency_s: float
    chunks_run: int = 0
    cancelled: bool = False   # an LLM decode was started and hit-cancelled
    tokens: int = 0           # token ids the LLM generated for this answer


@dataclasses.dataclass
class RuntimeCfg:
    s_th_run: float = 0.9
    parallel: bool = True
    add_misses: bool = False   # §3.1: optionally add new pairs on miss


class StorInferRuntime:
    def __init__(self, index, store, embedder, engine=None,
                 cfg: RuntimeCfg = None):
        """index: any IndexProtocol over store embeddings (FlatIndex);
        store: PrecomputedStore; engine: serving.Engine or None (search-only
        mode returns misses without LLM fallback)."""
        self.index = index
        self.store = store
        self.embedder = embedder
        self.engine = engine
        self.cfg = cfg or RuntimeCfg()
        self._pool = ThreadPoolExecutor(max_workers=2)

    # -- the search half ------------------------------------------------------
    def _search_emb(self, text: str):
        """Score + row + the query embedding (threaded through so the
        §3.1 write-back path never re-encodes what search already did)."""
        t0 = time.perf_counter()
        e = self.embedder.encode([text])
        v, i = self.index.search(e, 1)
        dt = time.perf_counter() - t0
        return float(v[0, 0]), int(i[0, 0]), e, dt

    def search(self, text: str):
        score, row, _, dt = self._search_emb(text)
        return score, row, dt

    # -- full parallel query path ----------------------------------------------
    def query(self, text: str, *, max_new: int = 32,
              temperature=None) -> QueryResult:
        t0 = time.perf_counter()
        fut = self._pool.submit(self._search_emb, text)

        session = None
        if self.engine is not None:
            session = self.engine.start_session(text, max_new=max_new,
                                                temperature=temperature)

        score = row = emb = search_s = None
        while session is not None and not session.done:
            if fut.done():
                score, row, emb, search_s = fut.result()
                if score >= self.cfg.s_th_run:
                    session.cancel()         # Fig 2 termination signal
                break                        # miss: decode continues below
            session.step_chunk()
        if score is None:                    # session won the race (or none)
            score, row, emb, search_s = fut.result()

        if score >= self.cfg.s_th_run:
            mq, resp = self.store.get_pair(row)
            return QueryResult(
                response=resp, source="store", hit=True, score=score,
                matched_query=mq, search_s=search_s,
                llm_s=(session.decode_s + session.prefill_s) if session
                else 0.0,
                latency_s=time.perf_counter() - t0,
                chunks_run=session.chunks_run if session else 0,
                cancelled=bool(session is not None and session.cancelled))

        # miss: let the LLM finish (it kept decoding the whole time)
        llm_text = ""
        if session is not None:
            while not session.done:
                session.step_chunk()
            llm_text = session.text()
            if self.cfg.add_misses:
                # the race's search already encoded this query — reuse it
                self.store.add_batch(emb, [text], [llm_text])
        return QueryResult(
            response=llm_text, source="llm", hit=False, score=score,
            matched_query=None, search_s=search_s,
            llm_s=(session.decode_s + session.prefill_s) if session else 0.0,
            latency_s=time.perf_counter() - t0,
            chunks_run=session.chunks_run if session else 0,
            tokens=len(session.out_ids) if session else 0)

    # -- batched search (benchmarks) --------------------------------------------
    def search_batch(self, texts, k: int = 1):
        t0 = time.perf_counter()
        e = self.embedder.encode(list(texts))
        v, i = self.index.search(e, k)
        return v, i, time.perf_counter() - t0

    def close(self):
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "StorInferRuntime":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Batched serving runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchedRuntimeCfg:
    s_th_run: float = 0.9
    max_batch: int = 32        # microbatch ceiling for the admission queue
    max_wait_s: float = 0.005  # admission window after the first arrival
    add_misses: bool = False   # §3.1 write-back of fresh (query, response)
    rebuild_every: int = 256   # write-backs between flush + index rebuild
    engine_slots: Optional[int] = None  # sync-path decode slots
    #                                     (None: one per query in the batch)
    # -- ServingPipeline knobs (the serve()/submit() front door) ----------
    decode_slots: int = 4      # persistent continuous-batching slot count
    queue_depth: int = 64      # per-stage bounded queue depth (backpressure)
    async_writeback: bool = True   # §3.1 write-back + rebuild off the
    #                                critical path on a background worker


@dataclasses.dataclass
class RuntimeStats:
    """Serving counters; ``llm_cancelled`` is the hit-cancellation
    accounting — decodes that were started and then killed by a store hit."""
    queries: int = 0
    hits: int = 0
    misses: int = 0
    llm_cancelled: int = 0
    batches: int = 0
    writebacks: int = 0
    index_rebuilds: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0


class BatchedRuntime:
    """Batched StorInfer serving over the staged pipeline.

    The async front door (``serve``/``submit``) runs the stage-decoupled
    ``ServingPipeline``: hits resolve at search time, misses decode on a
    persistent continuous-batching scheduler, write-backs rebuild the
    index in the background. ``query_batch`` is the synchronous
    compatibility path: one embed + one MIPS search + one batched decode
    racing it, hit slots cancelled mid-flight — same stage helpers, with
    a barrier at the end.

    ``index`` may be any IndexProtocol (FlatIndex or IVFIndex); use
    ``BatchedRuntime.from_store`` to let ``auto_index`` pick the tier.
    ``engine=None`` runs search-only (misses return empty responses).
    """

    def __init__(self, index, store, embedder, engine=None,
                 cfg: BatchedRuntimeCfg = None, mesh=None,
                 auto_index_kw: Optional[dict] = None, rebuild=None):
        """``rebuild``: optional ``(store, mesh) -> index`` callable used
        by ``flush_and_rebuild`` instead of ``auto_index`` — callers that
        pinned a specific tier (the facade's declarative cfg) use it to
        keep write-back rebuilds on that tier."""
        self.index = index
        self.store = store
        self.embedder = embedder
        self.engine = engine
        self.cfg = cfg or BatchedRuntimeCfg()
        self.mesh = mesh
        self._auto_index_kw = dict(auto_index_kw or {})
        self._rebuild = rebuild
        self.stats = RuntimeStats()
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._pipeline = None
        self._last_pipeline = None       # stats survive stop_serving()
        self._pipeline_lock = threading.Lock()
        self._stats_lock = threading.Lock()    # pipeline workers + sync path
        self._index_lock = threading.Lock()    # atomic index swap vs search
        self._wb_lock = threading.Lock()       # write-back accounting
        self._rebuild_lock = threading.Lock()  # one rebuild at a time
        self._pending_writebacks = 0

    @classmethod
    def from_store(cls, store, embedder, engine=None,
                   cfg: BatchedRuntimeCfg = None, mesh=None,
                   cache_dir=None, **auto_index_kw) -> "BatchedRuntime":
        """Let ``auto_index`` pick the tier (``auto_index_kw`` are its
        keywords, ``device`` among them). ``cache_dir`` enables the
        persisted-IVF path: ``"store"`` uses the store's own root, any
        other path is used as-is. Reopening a paper-scale store then loads
        the k-means product instead of refitting it; ``flush_and_rebuild``
        refreshes the same cache as the store grows (the stale row count
        forces a refit + re-save)."""
        from repro_torch.core.index import auto_index
        if cache_dir is not None:
            auto_index_kw["cache_dir"] = str(
                store.root if cache_dir == "store" else cache_dir)
        return cls(auto_index(store, mesh, **auto_index_kw), store,
                   embedder, engine, cfg=cfg, mesh=mesh,
                   auto_index_kw=auto_index_kw)

    # -- the search half (stage 2 of the pipeline) ----------------------------
    def _search_batch(self, texts: List[str]):
        t0 = time.perf_counter()
        embs = self.embedder.encode(texts)
        with self._index_lock:
            index = self.index      # snapshot: rebuilds swap atomically;
        #                             an in-flight search keeps the old one
        v, i = index.search(embs, 1)
        return v[:, 0], i[:, 0], embs, time.perf_counter() - t0

    # -- synchronous batched query path ---------------------------------------
    def query_batch(self, texts: Sequence[str], *,
                    max_new: Union[int, Sequence[int]] = 32,
                    temperature=None) -> List[QueryResult]:
        """The synchronous compatibility path: the whole batch returns
        together, but each ``QueryResult`` carries ITS OWN resolve time —
        hits are stamped when the search returned (the moment the staged
        pipeline would have resolved them), misses when their decode slot
        retired — so latency percentiles computed from a batch are real,
        not one batch-wide number repeated."""
        texts = list(texts)
        if not texts:
            return []
        t0 = time.perf_counter()
        fut = self._pool.submit(self._search_batch, texts)

        session = None
        if self.engine is not None:
            session = self.engine.start_batch_session(
                texts, max_new=max_new, temperature=temperature,
                batch_size=self.cfg.engine_slots)

        # race: batched decode vs batched search (Fig 2, amortized)
        search = None
        while session is not None and not session.done:
            if fut.done():
                search = fut.result()
                for qi, s in enumerate(search[0]):
                    if s >= self.cfg.s_th_run:
                        session.cancel(qi)   # termination signal per slot
                break                        # misses keep decoding below
            session.step_chunk()
        if search is None:
            search = fut.result()
        t_searched = time.perf_counter()     # hits are resolvable NOW
        scores, rows, embs, search_s = search
        cancelled_rids = set()
        reqs = {}
        if session is not None:
            session.run()                    # only miss slots still live
            # a cancel only saved decode work if the request had actually
            # entered a decode wave (slot assigned); cancelled-while-waiting
            # or finished-before-cancel don't count
            reqs = {r.rid: r for r in session.results()}
            cancelled_rids = {rid for rid, r in reqs.items()
                              if r.cancelled and r.slot >= 0}

        results: List[QueryResult] = []
        miss_idx: List[int] = []
        llm_s = session.decode_s if session is not None else 0.0
        hit_latency = t_searched - t0
        for qi, text in enumerate(texts):
            score = float(scores[qi])
            req = reqs.get(qi)
            chunks = req.chunks if req is not None else 0
            if score >= self.cfg.s_th_run:
                mq, resp = self.store.get_pair(int(rows[qi]))
                results.append(QueryResult(
                    response=resp, source="store", hit=True, score=score,
                    matched_query=mq, search_s=search_s, llm_s=llm_s,
                    latency_s=hit_latency, chunks_run=chunks,
                    cancelled=qi in cancelled_rids))
            else:
                miss_idx.append(qi)
                resp = session.text(qi) if session is not None else ""
                done = (req.t_done if req is not None and req.t_done
                        else t_searched)
                results.append(QueryResult(
                    response=resp, source="llm", hit=False, score=score,
                    matched_query=None, search_s=search_s, llm_s=llm_s,
                    latency_s=done - t0, chunks_run=chunks,
                    tokens=len(req.out_ids) if req is not None else 0))

        n_hits = len(texts) - len(miss_idx)
        with self._stats_lock:
            self.stats.queries += len(texts)
            self.stats.hits += n_hits
            self.stats.misses += len(miss_idx)
            self.stats.batches += 1
            self.stats.llm_cancelled += len(cancelled_rids)

        if (self.cfg.add_misses and session is not None and miss_idx):
            import numpy as np
            self._writeback(np.asarray(embs)[miss_idx],
                            [texts[qi] for qi in miss_idx],
                            [results[qi].response for qi in miss_idx])
        return results

    # -- §3.1 write-back + rebuild (stage 5 of the pipeline) ------------------
    def _writeback(self, embs, texts, responses):
        """Append fresh (query, response) pairs and trigger the periodic
        flush + rebuild. Called synchronously by ``query_batch`` and from
        the pipeline's background write-back worker."""
        import numpy as np
        with self._wb_lock:
            self.store.add_batch(np.asarray(embs), list(texts),
                                 list(responses))
            with self._stats_lock:
                self.stats.writebacks += len(texts)
            self._pending_writebacks += len(texts)
            need = self._pending_writebacks >= self.cfg.rebuild_every
        if need:
            self.flush_and_rebuild()

    def flush_and_rebuild(self):
        """Persist pending write-backs and rebuild the index over the grown
        store, then SWAP it atomically under the index lock — searches in
        flight keep their snapshot, later ones see the new index. With the
        default ``auto_index`` path the tier is re-picked (a store that
        outgrew the flat boundary moves to IVF); a ``rebuild`` callable
        pins the caller's choice."""
        with self._rebuild_lock:
            self.store.flush()
            if self._rebuild is not None:
                new_index = self._rebuild(self.store, self.mesh)
            else:
                from repro_torch.core.index import auto_index
                new_index = auto_index(self.store, self.mesh,
                                       **self._auto_index_kw)
            with self._index_lock:
                self.index = new_index
            with self._stats_lock:
                self.stats.index_rebuilds += 1
            with self._wb_lock:
                self._pending_writebacks = 0

    # -- async admission (the serving front door) -----------------------------
    def serve(self):
        """Start (or return) the staged ServingPipeline. Safe to call from
        many threads — ``submit`` races here on first use, and two
        pipelines would interleave reads on the shared store handle."""
        from repro_torch.serving.scheduler import ServingPipeline
        with self._pipeline_lock:
            if self._pipeline is None:
                self._pipeline = ServingPipeline(
                    self, max_batch=self.cfg.max_batch,
                    max_wait_s=self.cfg.max_wait_s,
                    queue_depth=self.cfg.queue_depth,
                    decode_slots=self.cfg.decode_slots,
                    async_writeback=self.cfg.async_writeback).start()
                self._last_pipeline = self._pipeline
            return self._pipeline

    def submit(self, text: str, *, max_new: int = 32,
               temperature=None) -> Future:
        """Enqueue one query; a hit resolves the moment its microbatch's
        search returns, a miss when its decode slot retires.
        ``temperature`` applies to the miss decode (the scheduler admits
        same-temperature requests into one wave)."""
        return self.serve().submit(text, max_new=max_new,
                                   temperature=temperature)

    def pipeline_stats(self) -> Optional[dict]:
        """Snapshot of the staged pipeline's accounting (per-stage queue
        depth + wait, decode-slot reuse);
        None if serve() was never started. Survives ``stop_serving``."""
        p = self._pipeline or self._last_pipeline
        return p.stats_snapshot() if p is not None else None

    def stop_serving(self, drain: bool = True):
        """Stop the pipeline (if running) without tearing down the
        runtime — synchronous ``query_batch`` keeps working and ``serve``
        can start a fresh pipeline later."""
        with self._pipeline_lock:
            if self._pipeline is not None:
                self._pipeline.stop(drain=drain)
                self._pipeline = None

    def close(self):
        self.stop_serving()
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "BatchedRuntime":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
