"""Admission + staged serving pipeline for the batched StorInfer runtime
(port of the JAX package's ``serving/scheduler.py``; the code is
framework-free apart from its spans (``repro_torch.trace``), and the
decode stage drives the port's ``BatchScheduler``).

Serving millions of users means queries arrive one at a time but must be
*processed* together: one embedding batch, one MIPS search batch through
the index, one LLM dispatch for the misses — the lookup cost amortized
across every in-flight request. Two layers live here:

``MicroBatcher`` — the generic collect-a-microbatch-and-call-back queue
(kept as the transport-agnostic building block and the synchronous
compatibility path's admission layer):

  submit(item) -> Future        (any thread)
        |                               queue
        v
  worker thread: collect up to ``max_batch`` items, waiting at most
  ``max_wait_s`` after the first arrival, then call
  ``process_batch(items) -> results`` and resolve the futures.

``ServingPipeline`` — the stage-decoupled serving loop (§3.4, Fig 2 made
pipelined). The monolithic per-microbatch barrier (embed + search + full
batched decode + write-back, every future resolved only when the slowest
miss finished) is broken into workers connected by bounded queues:

  submit() ─▶ [admit q] ─▶ search worker (microbatched embed + MIPS)
                  │ hits (score >= S_th_Run)        │ misses
                  ▼                                 ▼
           [resolve q] ─▶ resolve worker     [decode q] ─▶ decode worker
             store.get_pair, future            persistent BatchScheduler:
             resolved the moment the           freed slots refilled from
             search returned — NEVER           newly-searched misses
             waits on any decode               between waves
                                                    │ §3.1 write-backs
                                                    ▼
                                             [writeback q] ─▶ writeback
                                               worker: store.add_batch +
                                               flush_and_rebuild off the
                                               critical path; the index
                                               is swapped atomically
                                               under the runtime's lock

Every queue is bounded (``queue_depth``), so a slow stage exerts
backpressure on its producer instead of buffering unboundedly —
``submit`` itself blocks once the admit queue is full.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import CancelledError, Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import trace


@dataclasses.dataclass
class Submission:
    """One queued query, its per-request generation knobs, and the
    per-stage stamps the pipeline fills in as it flows through. ``rid``
    is unique in its pipeline: the decode stage's ``Request.rid`` and the
    request id of its spans (``repro_torch.trace``)."""
    text: str
    max_new: int = 32
    temperature: Optional[float] = None
    future: Future = dataclasses.field(default_factory=Future)
    rid: int = -1
    # pipeline routing + timing (stamped by the stages)
    t_admit: float = 0.0      # perf_counter at submit()
    t_search: float = 0.0     # search stage resolved the score
    t_routed: float = 0.0     # enqueued to the next stage
    hit: bool = False
    score: float = 0.0
    row: int = -1
    embedding: Optional[np.ndarray] = None   # threaded to write-back


@dataclasses.dataclass
class BatcherStats:
    batches: int = 0
    items: int = 0
    max_batch_seen: int = 0

    @property
    def mean_batch(self) -> float:
        return self.items / self.batches if self.batches else 0.0


class MicroBatcher:
    """Drains a submission queue into microbatches on a worker thread.

    ``process_batch`` receives a list of ``Submission`` and must return one
    result per submission (same order). Exceptions fail every future in
    the batch — the callers see the error, the worker keeps serving.
    """

    def __init__(self, process_batch: Callable[[List[Submission]],
                                               Sequence[Any]],
                 *, max_batch: int = 32, max_wait_s: float = 0.005):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._process = process_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.stats = BatcherStats()
        self._q: "queue.Queue[Optional[Submission]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._worker is None or not self._worker.is_alive():
            self._stopping = False
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="microbatcher")
            self._worker.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the worker. ``drain=True`` processes what is already
        queued first; otherwise pending futures are cancelled. Either
        way ``_stopping`` is raised FIRST, so a concurrent ``submit``
        cannot slip a submission in behind the shutdown sentinel (where
        its future would hang unresolved forever)."""
        if self._worker is None:
            return
        self._stopping = True
        if not drain:
            try:
                while True:
                    sub = self._q.get_nowait()
                    if sub is not None:
                        sub.future.cancel()
            except queue.Empty:
                pass
        self._q.put(None)                      # wake + shutdown sentinel
        self._worker.join(timeout=30)
        self._worker = None

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- producer side ------------------------------------------------------
    def submit(self, text: str, *, max_new: int = 32) -> Future:
        if (self._stopping or self._worker is None
                or not self._worker.is_alive()):
            raise RuntimeError("MicroBatcher is not running; call start()")
        sub = Submission(text=text, max_new=max_new)
        self._q.put(sub)
        # re-check AFTER the put: a concurrent stop() may have slipped its
        # sentinel in between the check above and our enqueue, leaving
        # this submission behind it where no worker would ever resolve
        # it. cancel() failing means the worker raced us and took it —
        # then the future resolves normally and the submit stands.
        if self._stopping and sub.future.cancel():
            raise RuntimeError("MicroBatcher is not running; call start()")
        return sub.future

    # -- worker side --------------------------------------------------------
    def _collect(self) -> Optional[List[Submission]]:
        """Block for the first item, then batch what arrives within the
        wait window. Returns None on the shutdown sentinel."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:                     # re-queue sentinel and stop
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            # atomically move futures to RUNNING; a False return means the
            # caller cancelled first (and cancel() can no longer succeed
            # afterwards, so set_result below cannot race)
            batch = [s for s in batch
                     if s.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                results = self._process(batch)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"process_batch returned {len(results)} results "
                        f"for {len(batch)} submissions")
            except Exception as e:              # noqa: BLE001
                for s in batch:
                    s.future.set_exception(e)
                continue
            self.stats.batches += 1
            self.stats.items += len(batch)
            self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                            len(batch))
            for s, r in zip(batch, results):
                s.future.set_result(r)


# ---------------------------------------------------------------------------
# Stage-decoupled serving pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageStats:
    """Per-stage accounting: items through the stage, cumulative time
    those items spent queued BEFORE it (the stage's admission wait), and
    the deepest its input queue got (backpressure indicator)."""
    items: int = 0
    wait_s: float = 0.0
    max_depth: int = 0

    @property
    def mean_wait_ms(self) -> float:
        return self.wait_s / self.items * 1e3 if self.items else 0.0


class PipelineStats:
    """Thread-safe pipeline accounting: per-stage queue depth + wait."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {
            "search": StageStats(), "resolve": StageStats(),
            "decode": StageStats(), "writeback": StageStats()}
        self.search_batches = 0
        self.writeback_errors = 0
        self._lock = threading.Lock()

    def record_wait(self, stage: str, wait_s: float, depth: int, n: int = 1):
        with self._lock:
            st = self.stages[stage]
            st.items += n
            st.wait_s += wait_s
            st.max_depth = max(st.max_depth, depth)

    def snapshot(self, depths: Optional[Dict[str, int]] = None) -> dict:
        """Plain-dict view (the ``SystemStats.pipeline`` payload)."""
        with self._lock:
            return {
                "stages": {
                    name: {"items": st.items,
                           "mean_wait_ms": st.mean_wait_ms,
                           "max_depth": st.max_depth,
                           "depth": (depths or {}).get(name, 0)}
                    for name, st in self.stages.items()},
                "search_batches": self.search_batches,
                "writeback_errors": self.writeback_errors,
            }


class ServingPipeline:
    """The stage-decoupled serving loop over a ``BatchedRuntime`` (see the
    module docstring for the stage diagram).

    Contracts:

    * a HIT future resolves the moment its microbatch's MIPS search
      returns — it never waits on any decode;
    * misses flow into ONE persistent continuous-batching
      ``BatchScheduler``: freed decode slots (finished or cancelled) are
      refilled from newly-searched misses between waves, never a full
      batch teardown per admission;
    * §3.1 write-back and ``flush_and_rebuild`` run on a background
      worker (``async_writeback``), the rebuilt index swapped atomically
      under the runtime's index lock — in-flight searches keep the old
      snapshot, later ones see the new;
    * every queue is bounded: a saturated stage blocks its producer
      (``submit`` included) instead of buffering without limit.

    ``stop(drain=True)`` flows a sentinel through every stage in order,
    so nothing already admitted is dropped; ``drain=False`` cancels
    queued + in-flight futures (``CancelledError``) and tears down fast.
    """

    def __init__(self, runtime, *, max_batch: int = 32,
                 max_wait_s: float = 0.005, queue_depth: int = 64,
                 decode_slots: int = 4, async_writeback: bool = True):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if decode_slots < 1:
            raise ValueError("decode_slots must be >= 1")
        self.rt = runtime
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.decode_slots = decode_slots
        self.async_writeback = async_writeback
        self.stats = PipelineStats()
        self._rids = itertools.count()   # Submission.rid
        self._admit_q: "queue.Queue[Optional[Submission]]" = \
            queue.Queue(maxsize=queue_depth)
        self._resolve_q: "queue.Queue[Optional[Submission]]" = \
            queue.Queue(maxsize=queue_depth)
        self._decode_q: "queue.Queue[Optional[Submission]]" = \
            queue.Queue(maxsize=queue_depth)
        self._wb_q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self.scheduler = None            # the decode worker's BatchScheduler
        self._threads: List[threading.Thread] = []
        self._stopping = False
        self._abort = False
        self._admit_done = False         # search worker saw the sentinel
        self._lifecycle = threading.Lock()

    @property
    def _has_decode(self) -> bool:
        return self.rt.engine is not None

    @property
    def _wants_writeback(self) -> bool:
        return self._has_decode and self.rt.cfg.add_misses

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingPipeline":
        with self._lifecycle:
            if self._threads:
                return self
            self._stopping = self._abort = self._admit_done = False
            workers = [("pipeline-search", self._search_worker),
                       ("pipeline-resolve", self._resolve_worker)]
            if self._has_decode:
                workers.append(("pipeline-decode", self._decode_worker))
            if self._wants_writeback and self.async_writeback:
                workers.append(("pipeline-writeback",
                                self._writeback_worker))
            self._threads = [threading.Thread(target=fn, daemon=True,
                                              name=name)
                             for name, fn in workers]
            for t in self._threads:
                t.start()
            return self

    def stop(self, drain: bool = True):
        """Stop every stage. ``drain=True`` finishes everything already
        admitted first (sentinels flow admit → search → resolve/decode →
        write-back); ``drain=False`` cancels pending + in-flight work."""
        with self._lifecycle:
            if not self._threads:
                return
            self._stopping = True
            if not drain:
                self._abort = True
            self._admit_q.put(None)
            for t in self._threads:
                t.join(timeout=60)
            # anything that slipped into a queue behind the sentinels
            for q_ in (self._admit_q, self._resolve_q, self._decode_q):
                try:
                    while True:
                        s = q_.get_nowait()
                        if s is not None:
                            _cancel_future(s.future)
                except queue.Empty:
                    pass
            self._threads = []

    def __enter__(self) -> "ServingPipeline":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- producer side ------------------------------------------------------
    def submit(self, text: str, *, max_new: int = 32,
               temperature: Optional[float] = None) -> Future:
        """Enqueue one query (blocks when the admit queue is full — the
        pipeline's backpressure reaches the caller). The future resolves
        to a ``QueryResult``: at search time for hits, at decode
        completion for misses."""
        if self._stopping or not self._alive():
            raise RuntimeError("ServingPipeline is not running; "
                               "call start()")
        sub = Submission(text=text, max_new=max_new,
                         temperature=temperature, rid=next(self._rids))
        sub.t_admit = time.perf_counter()
        # backpressure put that cannot strand the caller: while the
        # pipeline runs this blocks like a plain put, but a producer
        # parked on a FULL queue whose workers have stopped (no consumer
        # left, cleanup drain already past) must wake up and bail
        while True:
            try:
                self._admit_q.put(sub, timeout=0.05)
                break
            except queue.Full:
                if self._stopping:
                    raise RuntimeError("ServingPipeline is not running; "
                                       "call start()") from None
        # re-check AFTER the put: stop() may have raced us between the
        # aliveness check and the enqueue, and a submission landing after
        # its drain would hang forever. cancel() failing means a worker
        # took it first — then it resolves normally.
        if self._stopping and sub.future.cancel():
            raise RuntimeError("ServingPipeline is not running; "
                               "call start()")
        return sub.future

    def _alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def queue_depths(self) -> Dict[str, int]:
        return {"search": self._admit_q.qsize(),
                "resolve": self._resolve_q.qsize(),
                "decode": self._decode_q.qsize(),
                "writeback": self._wb_q.qsize()}

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot(self.queue_depths())
        sched = self.scheduler
        if sched is not None:
            snap["decode_slots"] = {"slots": sched.B, "waves": sched.waves,
                                    "admitted": sched.admitted,
                                    "slot_uses": list(sched.slot_uses)}
        return snap

    # -- stage 2: embed + MIPS search (microbatched) ------------------------
    def _collect(self) -> List[Submission]:
        """Block for the first item, microbatch the rest of the wait
        window. A consumed shutdown sentinel sets ``_admit_done`` instead
        of being re-queued — re-putting into the BOUNDED admit queue
        could block forever against producers refilling the freed slots
        (this worker is the queue's only consumer)."""
        first = self._admit_q.get()
        if first is None:
            self._admit_done = True
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._admit_q.get_nowait() if remaining <= 0
                       else self._admit_q.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:
                self._admit_done = True
                break
            batch.append(nxt)
        return batch

    def _search_worker(self):
        while not self._admit_done:
            batch = self._collect()
            if not batch:
                continue
            batch = [s for s in batch
                     if s.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            if self._abort:
                for s in batch:
                    _cancel_future(s.future)
                continue
            now = time.perf_counter()
            self.stats.record_wait(
                "search", sum(now - s.t_admit for s in batch),
                self._admit_q.qsize() + len(batch), n=len(batch))
            ts = trace.start()
            try:
                scores, rows, embs, _ = self.rt._search_batch(
                    [s.text for s in batch])
            except Exception as e:              # noqa: BLE001
                for s in batch:
                    _set_future_exception(s.future, e)
                continue
            if ts is not None:
                trace.end(ts, "search.batch", rids=[s.rid for s in batch],
                          n=len(batch))
            t = time.perf_counter()
            embs = np.asarray(embs)
            with self.rt._stats_lock:
                self.rt.stats.batches += 1
            with self.stats._lock:
                self.stats.search_batches += 1
            s_th = self.rt.cfg.s_th_run
            for qi, s in enumerate(batch):
                s.t_search = t
                s.score = float(scores[qi])
                s.row = int(rows[qi])
                s.hit = s.score >= s_th
                s.t_routed = time.perf_counter()
                if s.hit or not self._has_decode:
                    self._resolve_q.put(s)       # stage 3: hit-resolve
                else:
                    s.embedding = embs[qi]       # threaded to write-back
                    self._decode_q.put(s)        # stage 4: decode
        # shutdown: propagate the sentinel downstream
        self._resolve_q.put(None)
        if self._has_decode:
            self._decode_q.put(None)

    # -- stage 3: hit-resolve (and engine-less miss resolve) ----------------
    def _resolve_worker(self):
        from repro_torch.core.runtime import QueryResult
        while True:
            s = self._resolve_q.get()
            if s is None:
                break
            if self._abort:
                _cancel_future(s.future)
                continue
            now = time.perf_counter()
            self.stats.record_wait("resolve", now - s.t_routed,
                                   self._resolve_q.qsize() + 1)
            try:
                if s.hit:
                    mq, resp = self.rt.store.get_pair(s.row)
                else:                   # miss with no engine behind it
                    mq, resp = None, ""
                done = time.perf_counter()
                qr = QueryResult(
                    response=resp, source="store" if s.hit else "llm",
                    hit=s.hit, score=s.score, matched_query=mq,
                    search_s=s.t_search - s.t_admit, llm_s=0.0,
                    latency_s=done - s.t_admit)
                self._account(qr)
                s.future.set_result(qr)
            except Exception as e:              # noqa: BLE001
                _set_future_exception(s.future, e)

    # -- stage 4: continuous-batching decode --------------------------------
    def _decode_worker(self):
        pending: Dict[int, Submission] = {}
        try:
            self._decode_loop(pending)
        except Exception as e:              # noqa: BLE001 — engine died:
            # fail everything in flight, then keep consuming (failing new
            # arrivals) until the shutdown sentinel so no future hangs
            for s in pending.values():
                _set_future_exception(s.future, e)
            pending.clear()
            while True:
                s = self._decode_q.get()
                if s is None:
                    break
                _set_future_exception(s.future, e)
        if self._wants_writeback and self.async_writeback:
            self._wb_q.put(None)

    def _decode_loop(self, pending: Dict[int, "Submission"]):
        from repro_torch.serving.engine import BatchScheduler, Request
        sched = BatchScheduler(self.rt.engine,
                               batch_size=self.decode_slots)
        self.scheduler = sched
        sentinel = False

        def admit(s: Submission):
            now = time.perf_counter()
            self.stats.record_wait("decode", now - s.t_routed,
                                   self._decode_q.qsize() + 1)
            req = Request(rid=s.rid, prompt=s.text, max_new=s.max_new,
                          temperature=s.temperature, t_queued=s.t_routed)
            pending[s.rid] = s
            sched.submit(req)

        while True:
            if not pending:
                if sentinel:
                    break
                s = self._decode_q.get()     # idle: block for work
                if s is None:
                    break
                if self._abort:
                    _cancel_future(s.future)
                    continue
                admit(s)
            if not sentinel:
                # refill: everything already searched joins the slot pool
                # now, so freed slots are reused between waves
                try:
                    while True:
                        s = self._decode_q.get_nowait()
                        if s is None:
                            sentinel = True
                            break
                        if self._abort:
                            _cancel_future(s.future)
                        else:
                            admit(s)
                except queue.Empty:
                    pass
            if self._abort:
                for s in pending.values():
                    _cancel_future(s.future)
                pending.clear()
                continue
            if pending:
                sched.step_chunk()           # admit into free slots + decode
                for r in sched.drain_finished():
                    self._finish_miss(pending.pop(r.rid), r)

    def _finish_miss(self, s: Submission, req):
        from repro_torch.core.runtime import QueryResult
        now = time.perf_counter()
        text = self.rt.engine.tok.decode(req.out_ids) if req.out_ids else ""
        qr = QueryResult(
            response=text, source="llm", hit=False, score=s.score,
            matched_query=None, search_s=s.t_search - s.t_admit,
            llm_s=now - s.t_search, latency_s=now - s.t_admit,
            chunks_run=req.chunks, cancelled=req.cancelled,
            tokens=len(req.out_ids))
        self._account(qr)
        try:
            s.future.set_result(qr)
        except InvalidStateError:
            pass
        if self._wants_writeback and text:
            if self.async_writeback:         # stage 5: off the critical path
                self._wb_q.put((time.perf_counter(), s.embedding, s.text,
                                text))
            else:
                self.rt._writeback(np.asarray([s.embedding]), [s.text],
                                   [text])

    # -- stage 5: async write-back + background rebuild ---------------------
    def _writeback_worker(self):
        while True:
            item = self._wb_q.get()
            if item is None:
                break
            items = [item]
            done = False
            try:
                while True:                  # batch whatever is queued
                    nxt = self._wb_q.get_nowait()
                    if nxt is None:
                        done = True
                        break
                    items.append(nxt)
            except queue.Empty:
                pass
            if not self._abort:
                # wait = how long each pair actually sat queued (a slow
                # flush_and_rebuild shows up here, the stage's real
                # backpressure signal)
                now = time.perf_counter()
                self.stats.record_wait(
                    "writeback", sum(now - t for t, _, _, _ in items),
                    self._wb_q.qsize() + len(items), n=len(items))
                try:
                    self.rt._writeback(
                        np.stack([e for _, e, _, _ in items]),
                        [q for _, _, q, _ in items],
                        [r for _, _, _, r in items])
                except Exception:            # noqa: BLE001
                    with self.stats._lock:
                        self.stats.writeback_errors += len(items)
            if done:
                break

    def _account(self, qr):
        with self.rt._stats_lock:
            st = self.rt.stats
            st.queries += 1
            st.hits += int(qr.hit)
            st.misses += int(not qr.hit)


def _cancel_future(f: Future):
    """Cancel a pending future, or fail a running one with
    CancelledError — either way result() stops blocking."""
    if not f.cancel():
        _set_future_exception(f, CancelledError())


def _set_future_exception(f: Future, e: BaseException):
    try:
        f.set_exception(e)
    except InvalidStateError:
        pass
