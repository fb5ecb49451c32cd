"""The benchmark's own spans around the calls into the program, the trace
of part of the window, and the context the metric readers read.

Spans (kept in memory, read once the window has closed):

* ``search``: ``BatchedRuntime._search_batch``, the pipeline's embed +
  search stage for one microbatch (its texts, and what it returned);
* ``chunk``: ``BatchScheduler.step_chunk``, one scheduler step: the
  admission of waiting requests (``admit``: ``BatchScheduler._admit``,
  prefills included, which end in a host read of the first token) and one
  decode chunk, which ends in the host copy of its tokens. Its tokens are
  the output tokens the requests gained in it;
* the kernels' calls (``kernels/ops.py``'s wrappers) in a traced
  window, with their shapes, from which the least times follow.

A ``--trace 1`` run traces its whole window, so its span metrics carry
the profiler's cost (CUPTI records every launch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import roofline


@dataclasses.dataclass
class Search:
    t0: float
    t1: float
    texts: List[str]
    embs: np.ndarray
    scores: np.ndarray
    rows: np.ndarray


@dataclasses.dataclass
class Chunk:
    t0: float
    t1: float
    admit_s: float       # admission (prefills) inside the step
    admitted: int
    tokens: int          # output tokens gained, first tokens included
    live: int            # slots decoding in the chunk
    steps: int           # decode steps run (0 when no slot was live)
    cache_len: int       # the shared cache length the chunk started at
    decoded: List[int]   # tokens each live request gained in the decode


class Spans:
    def __init__(self):
        self.searches: List[Search] = []
        self.chunks: List[Chunk] = []
        self.finished: Dict[str, List[int]] = {}
        self.calls: Dict[str, list] = {"flash_attention": [],
                                       "decode_attention": [],
                                       "mips_topk": []}
        self.tracing = False


@contextlib.contextmanager
def instrument(rec: Spans, si, BatchScheduler, trace: bool):
    """Spans around the program's stage calls for the life of the block;
    everything patched is put back on exit."""
    rt = si._batched
    search = rt._search_batch

    def search_span(texts):
        t0 = time.perf_counter()
        v, i, embs, dt = search(texts)
        rec.searches.append(Search(t0, time.perf_counter(), list(texts),
                                   np.array(embs, np.float32, copy=True),
                                   np.array(v), np.array(i)))
        return v, i, embs, dt

    step, admit = BatchScheduler.step_chunk, BatchScheduler._admit

    def admit_span(sched):
        t0 = time.perf_counter()
        n = sched.admitted
        admit(sched)
        sched._sb_admit = (time.perf_counter() - t0, sched.admitted - n,
                           int(sched.live.sum()), sched.cache_len)

    def chunk_span(sched):
        before = {id(r): len(r.out_ids)
                  for r in list(sched.reqs) + sched.waiting + sched.finished
                  if r is not None}
        sched._sb_admit = (0.0, 0, int(sched.live.sum()), sched.cache_len)
        t0 = time.perf_counter()
        ran = step(sched)
        t1 = time.perf_counter()
        admit_s, admitted, live, clen = sched._sb_admit
        touched = [r for r in sched.reqs if r is not None] + sched.finished
        gained = [len(r.out_ids) - before.get(id(r), 0) for r in touched]
        firsts = [1 if id(r) not in before or before[id(r)] == 0 else 0
                  for r in touched]
        rec.chunks.append(Chunk(
            t0, t1, admit_s, admitted, sum(gained), live if ran else 0,
            sched.e.chunk if ran else 0, clen,
            [g - f for g, f in zip(gained, firsts) if g - f > 0]))
        for r in sched.finished:
            rec.finished[r.prompt] = list(r.out_ids)
        return ran

    from repro_torch.kernels import ops
    wrapped = {}

    def call_span(name, fn, shapes):
        # the wrapper passes itself to the launch counter: keep its name
        # and its counter attribute
        @functools.wraps(fn)
        def w(*a, **k):
            if rec.tracing:
                rec.calls[name].append(shapes(*a, **k))
            return fn(*a, **k)
        wrapped[name] = fn
        setattr(ops, name, w)

    rt._search_batch = search_span
    BatchScheduler.step_chunk, BatchScheduler._admit = chunk_span, admit_span
    if trace:
        call_span("flash_attention", ops.flash_attention, _flash_shapes)
        call_span("decode_attention", ops.decode_attention, _decode_shapes)
        call_span("mips_topk", ops.mips_topk, _mips_shapes)
    try:
        yield rec
    finally:
        rt.__dict__.pop("_search_batch", None)
        BatchScheduler.step_chunk, BatchScheduler._admit = step, admit
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _flash_shapes(q, k, v, causal=True):
    B, S, Hq, D = q.shape
    return roofline.flash_attention_s(B, S, Hq, D, k.shape[1], k.shape[2],
                                      v.shape[3], bool(causal), _dt(q))


def _decode_shapes(q, k, v, lengths, n_splits=8):
    # the lengths stay on the device until the window has closed
    return ("decode", q.shape, k.shape, v.shape, _dt(q), _dt(k), lengths)


def _mips_shapes(q, x, k, tile_n=512):
    return roofline.mips_topk_s(q.shape[0], x.shape[0], q.shape[1], int(k),
                                int(tile_n), _dt(q), _dt(x))


def least_s(call) -> float:
    if not isinstance(call, tuple):
        return call
    _, qs, ks, vs, qd, kd, lengths = call
    B, Hq, D = qs
    T = ks[1]
    att = int((lengths.clamp(max=T - 1) + 1).sum())
    return roofline.decode_attention_s(B, Hq, D, T, ks[2], vs[3], att, qd,
                                       kd)


KERNELS = {"flash_attention": "flash_attention_kernel",
           "decode_attention": "decode_attention_kernel",
           "mips_topk": "mips_tc_kernel"}


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: Dict[str, float]            # device seconds by operation name
    kernels: Dict[str, tuple]        # wrapper -> (launches, device s)
    least: Dict[str, tuple]          # wrapper -> (calls, least s summed)
    gaps: List[tuple]                # (t0, t1) host clock, idle device

    def breakdown(self, rec: Spans) -> dict:
        top = sorted(self.ops.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:96], s] for n, s in top],
                "idle_gaps": [[_host_doing(rec, (a + b) / 2), b - a]
                              for a, b in gaps]}


def _host_doing(rec: Spans, t: float) -> str:
    for s in rec.searches:
        if s.t0 <= t <= s.t1:
            return "host: embed + search (search worker)"
    for c in rec.chunks:
        if c.t0 <= t <= c.t0 + c.admit_s:
            return "host: admission and prefill (decode worker)"
        if c.t0 + c.admit_s < t <= c.t1:
            return "host: decode chunk (decode worker)"
    return "host: no span (queues, clients, scheduler bookkeeping)"


class Tracer:
    """``torch.profiler`` over the card's activity (no host op events)
    for the whole window, started in set-up while no other thread
    launches: its first start in a process sets up CUPTI, which took
    10-20 s on the card's host, and a start under the pipeline's launches
    once crashed the process. The host and device clocks are tied by
    reading the wall clock beside ``perf_counter`` as it starts."""

    def __init__(self, dev):
        self.dev = dev
        self.prof = None
        self.start_s = 0.0

    def start(self, rec: Spans):
        if self.dev.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.start_s = time.perf_counter() - t
        self.off_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self):
        """Stop once the pipeline has stopped: no other thread launches."""
        if self.prof is None:
            return
        torch.cuda.synchronize(self.dev)
        self.prof.stop()

    def read(self, rec: Spans, t0: float, t1: float) -> Optional[Trace]:
        """The trace inside the window [t0, t1]."""
        if self.prof is None:
            return None
        on = t0 * 1e9 + self.off_ns
        off = t1 * 1e9 + self.off_ns
        cuda = torch.autograd.DeviceType.CUDA
        spans, ops = [], {}
        kernels = {k: [0, 0.0] for k in KERNELS}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            a, b = max(e.start_ns(), on), min(e.end_ns(), off)
            if b <= a:
                continue
            name = e.name()
            spans.append((a, b))
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
            for w, kname in KERNELS.items():
                if kname in name:
                    kernels[w][0] += 1
                    kernels[w][1] += (e.end_ns() - e.start_ns()) / 1e9
        spans.sort()
        busy, gaps, cur = 0.0, [], None
        last = on
        for a, b in spans:
            if a > last:
                gaps.append(((last - self.off_ns) / 1e9,
                             (a - self.off_ns) / 1e9))
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
            last = max(last, b)
        if cur is not None:
            busy += cur[1] - cur[0]
        if off > last:
            gaps.append(((last - self.off_ns) / 1e9,
                         (off - self.off_ns) / 1e9))
        least = {w: (len(c), sum(least_s(x) for x in c))
                 for w, c in rec.calls.items()}
        return Trace(window_s=t1 - t0, busy_s=busy / 1e9,
                     ops=ops, kernels={k: tuple(v) for k, v in
                                       kernels.items()},
                     least=least, gaps=gaps)


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the configuration and mix files, the
    spans, the window (answered requests, counters at its edges, the
    trace) and the set-up time."""
    cfg: dict
    mix: dict
    rec: Spans
    win: object
    setup_s: float
    notes: List[str] = dataclasses.field(default_factory=list)

    def share_in_window(self, t0: float, t1: float) -> float:
        """The part of [t0, t1] inside the window, as a share of it."""
        w0, w1 = self.win.t0, self.win.t1
        if t1 <= t0:
            return 1.0 if w0 <= t1 <= w1 else 0.0
        return max(0.0, min(t1, w1) - max(t0, w0)) / (t1 - t0)

    def answered(self):
        """Requests answered inside the window, with their client-side
        times and results."""
        return [(r, ts, td, res) for r, ts, td, res in self.win.done
                if td <= self.win.t1 and not isinstance(res, BaseException)]

    def decode_chunks(self):
        """(chunk, its share inside the window) of every chunk that ran a
        decode there."""
        out = []
        for c in self.rec.chunks:
            f = self.share_in_window(c.t0, c.t1)
            if c.steps and f > 0:
                out.append((c, f))
        return out

    def roofline(self, wrapper: str) -> Optional[float]:
        """A kernel's least time per call over its device time per launch
        in the trace, in %; None where the trace holds no launch of it."""
        t = self.win.trace
        if t is None:
            return None
        launches, dev_s = t.kernels[wrapper]
        calls, least = t.least[wrapper]
        if not launches or not calls or dev_s <= 0:
            return None
        return 100.0 * (least / calls) / (dev_s / launches)
