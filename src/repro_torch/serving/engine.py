"""Serving engine: prefill + CHUNKED decode with inter-chunk cancellation
(port of the JAX package's ``serving/engine.py``).

Decode runs in chunks of K tokens; between chunks the host checks
cancellation (StorInfer's vector-search hit), so a session stops paying
for compute within <= one chunk. The same structure gives continuous
batching its insertion points.

Components:
  Engine          — prefill / decode-chunk programs for one config
  Session         — single-request chunked generation with .cancel()
  BatchScheduler  — fixed-slot continuous batching over a shared cache;
                    per-slot cancellation == StorInfer hit-cancellation

``BatchScheduler`` admits in one of two modes. By default in waves of
equal prompt length, and only while no slot decodes: the batch shares one
position, the reference's semantics, which ``BatchSession`` and the build
keep. ``ServingPipeline`` asks for continuous admission where the decode
rows are independent (``decode_rows_independent``: GQA attention on one
device, in a dense model or a layer pattern, with no expert capacity that
can drop an assignment at the slot count): each slot keeps its own
position, and a waiting request takes any free slot at the next chunk
boundary. An MoE whose capacity can drop stays on waves, since a token's
experts then depend on the other rows of its step; so do MLA, the
uniform ssm and hybrid stacks and the seq-sharded decode, which take one
position for the batch.

PyTorch runs eagerly, so there is nothing to compile; the caches are
updated in place (see ``models/model.py``). An EOS among a chunk's tokens
is kept in ``out_ids`` and ends the request in that chunk (the
reference's engine drops it and decodes on). The encdec and vlm families
are not served here: they need frames or M-RoPE positions, which a
tokens-only prefill does not have.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.tokenizer import EOS
from repro_torch.distributed.sharding import Sharded, shard
from repro_torch.models import model as M
from repro_torch.models import moe as Moe


def sample_token(logits, generator: torch.Generator, temperature):
    """Greedy (``temperature=None``, first-occurrence argmax) or a sample
    from softmax(logits / T). ``jax.random.categorical``'s stream cannot
    be reproduced, so sampled tokens match the reference in distribution
    only."""
    lg = logits.float()
    if temperature is None:
        return torch.argmax(lg, dim=-1)
    t = max(float(temperature), 1e-6)
    probs = torch.softmax(lg / t, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Engine:
    """One model on one device (or over ``run.mesh``); serves many
    sessions. ``run`` (the reference's ``RunCfg``) reaches every prefill
    and decode step; None keeps the port's kernel default (B4 prefill,
    B3 decode on a card), where the reference defaults to
    ``RunCfg(attn_impl="naive", remat=False)``."""

    def __init__(self, cfg, params, tokenizer, run: M.RunCfg = None,
                 max_len: int = 256, chunk: int = 8):
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is served through the "
                "model API (models/model.py: prefill with frames or "
                "mrope_positions, decode_step), not the Engine: the "
                "reference's engine prefills tokens only "
                "(src/repro/serving/engine.py:54-58), so it has no "
                + ("frames" if cfg.family == "encdec" else
                   "M-RoPE positions") + " to pass")
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self.run = run
        self.max_len = max_len
        self.chunk = chunk
        self.device = params["embed"]["w"].device

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def tokens(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor([list(ids)], dtype=torch.long, device=self.device)

    # -- programs -------------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, tokens):
        return M.prefill(self.cfg, self.params, {"tokens": tokens},
                         self.run or M.KERNEL, max_len=self.max_len)

    @torch.no_grad()
    def _decode_chunk(self, token, cache, cache_len, generator,
                      temperature, live, mean_len: int = None):
        """Runs ``chunk`` decode steps from position ``cache_len``: an int,
        or a (B,) long tensor on the device with each row's own position
        (``M.decode_step``), for which ``mean_len``, the host's mean of
        the live rows' positions, stands in the ``decode.step`` spans.
        live: (B,) bool — dead slots decode but their cache writes are
        masked out (slot freed semantics). Returns (token, cache,
        cache_len after the chunk, toks (B, chunk))."""
        toks = []
        at = cache_len if mean_len is None else mean_len
        for i in range(self.chunk):
            ts = trace.start()
            logits, cache = M.decode_step(self.cfg, self.params, token, cache,
                                          cache_len, self.run or M.RunCfg(),
                                          live=live)
            nxt = sample_token(logits[:, -1, :], generator, temperature)
            token = torch.where(live[:, None], nxt[:, None], token)
            if ts is not None:
                trace.end(ts, "decode.step", cache_len=at + i)
            toks.append(token[:, 0])
            cache_len = cache_len + 1     # never in place: a new tensor
        return token, cache, cache_len, torch.stack(toks, dim=1)

    @torch.no_grad()
    def _write_slot(self, batch_cache, one_cache, slot: int):
        """Insert a prefilled single-request cache at batch slot ``slot``
        (in place, cast to the batched cache's dtype). A seq-sharded leaf
        (``Sharded``) is written whole and laid out again."""
        for name, bc in batch_cache.items():
            one = one_cache[name]
            if isinstance(one, Sharded):
                one = one.full()
            if isinstance(bc, Sharded):
                whole = bc.full()
                whole[:, slot] = one[:, 0].to(whole.dtype)
                batch_cache[name] = shard(whole, bc.spec, bc.mesh)
            else:
                bc[:, slot] = one[:, 0].to(bc.dtype)
        return batch_cache

    # -- sessions -------------------------------------------------------------
    def start_session(self, prompt: str, max_new: int = 32, temperature=None,
                      seed: int = 0) -> "Session":
        return Session(self, prompt, max_new, temperature, seed)

    def start_batch_session(self, prompts, *, max_new=32, temperature=None,
                            batch_size: int = None) -> "BatchSession":
        return BatchSession(self, prompts, max_new=max_new,
                            temperature=temperature, batch_size=batch_size)

    # -- single-shot generation -----------------------------------------------
    def generate(self, prompt: str, max_new: int = 32, temperature=None,
                 seed: int = 0) -> str:
        """One prompt to its text: a ``Session`` run to completion."""
        s = self.start_session(prompt, max_new=max_new,
                               temperature=temperature, seed=seed)
        while not s.done:
            s.step_chunk()
        return s.text()

    def generate_batch(self, prompts, *, max_new=32, temperature=None,
                       batch_size: int = None) -> List[str]:
        """Prompts to their texts: a ``BatchSession`` run to completion."""
        s = self.start_batch_session(prompts, max_new=max_new,
                                     temperature=temperature,
                                     batch_size=batch_size)
        s.run()
        return [s.text(i) for i in range(s.n)]


class Session:
    """Single-request chunked generation with host-side cancellation."""

    def __init__(self, engine: Engine, prompt: str, max_new, temperature,
                 seed):
        self.e = engine
        ids = engine.tok.encode(prompt, bos=True)[: engine.max_len - 1]
        t0 = time.perf_counter()
        logits, cache = engine._prefill(engine.tokens(ids))
        first = int(torch.argmax(logits[0, -1]))
        self.prefill_s = time.perf_counter() - t0
        self.cache = cache
        self.cache_len = len(ids) - 1
        self.token = engine.tokens([first])
        self.out_ids: List[int] = [first]
        self.max_new = max_new
        self.temperature = temperature
        self.generator = engine.generator(seed)
        self.live = torch.ones((1,), dtype=torch.bool, device=engine.device)
        self.cancelled = False
        self.decode_s = 0.0
        self.chunks_run = 0

    @property
    def done(self) -> bool:
        return (self.cancelled or len(self.out_ids) >= self.max_new
                or (self.out_ids and self.out_ids[-1] == EOS))

    def cancel(self):
        """The paper's termination signal (takes effect between chunks)."""
        self.cancelled = True

    def step_chunk(self):
        if self.done:
            return
        t0 = time.perf_counter()
        self.token, self.cache, self.cache_len, toks = \
            self.e._decode_chunk(self.token, self.cache, self.cache_len + 1,
                                 self.generator, self.temperature, self.live)
        self.cache_len -= 1
        for t in toks[0].tolist():
            if len(self.out_ids) >= self.max_new:
                break
            self.out_ids.append(int(t))
            if t == EOS:        # kept, so ``done`` sees it
                break
        self.decode_s += time.perf_counter() - t0
        self.chunks_run += 1

    def text(self) -> str:
        return self.e.tok.decode(self.out_ids)


# ---------------------------------------------------------------------------
# Continuous batching with per-slot (hit-)cancellation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: str
    max_new: int = 32
    temperature: Optional[float] = None
    out_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    slot: int = -1
    t_done: float = 0.0       # perf_counter stamp when the slot retired
    chunks: int = 0           # decode chunks this request was live for
    t_queued: float = 0.0     # perf_counter stamp when it joined the decode
    #                           queue (0: not stamped); ends ``decode.queue``


def decode_rows_independent(cfg, run=None, batch: int = None) -> bool:
    """Whether a decode step's rows are independent of each other, so a
    request may join a batch that is mid-decode: the model takes per-row
    positions (``M.per_row_positions``) and, where it has experts, no
    assignment can drop at ``batch`` rows. An MoE layer caps each expert
    at ``moe.capacity`` assignments a call, ranked in slot order. A token
    ranks at most once per expert, so a capacity of at least ``batch``
    drops none, at that call and every smaller one. A smaller capacity
    makes a token's experts depend on the other rows of its step, and
    continuous admission would change its tokens, not only its speed:
    such a model stays on waves until its configuration and reference
    state a decode-time capacity. Without ``batch``, a model with experts
    answers false."""
    run = run or M.RunCfg()
    if not M.per_row_positions(cfg, run):
        return False
    if not cfg.n_experts:
        return True
    return batch is not None and Moe.capacity(cfg, batch) >= batch


class BatchScheduler:
    """Fixed B slots over one shared batched cache; requests enter by
    prefill -> slot write and leave on EOS/max/cancel. Cancellation is
    the StorInfer hit path: the slot is freed at the next chunk boundary.

    Wave admission (the default; the reference's semantics): the cache
    keeps a single shared ``cache_len``, so a new prompt may only be
    admitted when no slot is mid-decode (a mid-flight admission would
    reset ``cache_len`` under the live slots) and every prompt admitted
    into one wave must tokenize to the same length. Mixed-length traffic
    simply forms multiple waves.

    Continuous admission (``continuous=True``, which ``ServingPipeline``
    asks for where ``decode_rows_independent`` holds at ``batch_size``
    rows, and which is refused elsewhere): every slot keeps its own
    position in ``pos``, so at every chunk boundary the head of
    ``waiting`` is prefilled into each free slot, whatever the prompts'
    lengths and whether other slots are mid-decode. ``cache_len`` is then
    the rounded mean of the live slots' positions. Either way a chunk
    runs one temperature, so a request whose temperature differs from the
    live slots' waits at the head of ``waiting`` until they drain.

    The scheduler is PERSISTENT: slots join and leave between chunks (a
    freed slot — finished or hit-cancelled — is refilled from ``waiting``
    as soon as the wave drains, or at the next chunk boundary when
    continuous); ``waves`` (admission rounds) / ``admitted`` /
    ``slot_uses`` account for the reuse."""

    def __init__(self, engine: Engine, batch_size: int = 4,
                 continuous: bool = False):
        if continuous and not decode_rows_independent(engine.cfg, engine.run,
                                                      batch_size):
            raise ValueError(f"{engine.cfg.name}: continuous admission needs "
                             "independent decode rows: per-row decode "
                             "positions (GQA on one device) and no expert "
                             f"capacity that drops at {batch_size} slots")
        self.e = engine
        self.B = batch_size
        self.continuous = continuous
        self.cache = M.init_cache(engine.cfg, batch_size, engine.max_len,
                                  device=engine.device, run=engine.run)
        self.token = torch.zeros((batch_size, 1), dtype=torch.long,
                                 device=engine.device)
        self.live = np.zeros(batch_size, bool)
        self.reqs: List[Optional[Request]] = [None] * batch_size
        self.cache_len = 0
        self.pos = np.zeros(batch_size, np.int64)   # per slot (continuous)
        self.ran = np.zeros(batch_size, bool)       # decoded the last chunk
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.generator = engine.generator(0)
        self.waves = 0                      # admission waves opened
        self.admitted = 0                   # requests given a slot, ever
        self.slot_uses = [0] * batch_size   # admissions per slot (reuse)

    def submit(self, req: Request):
        if not req.t_queued:
            req.t_queued = trace.now() or 0.0
        self.waiting.append(req)

    @property
    def idle(self) -> bool:
        """Nothing decoding and nothing waiting for a slot."""
        return not self.live.any() and not self.waiting

    def drain_finished(self) -> List[Request]:
        """Pop and return everything finished since the last drain."""
        done, self.finished = self.finished, []
        return done

    def cancel(self, rid: int):
        for r in self.reqs:
            if r is not None and r.rid == rid:
                r.cancelled = True
        for r in self.waiting:
            if r.rid == rid:
                r.cancelled = True

    def _admit(self):
        if self.continuous:
            self._retire()  # a slot freed since the last chunk is free now
        elif self.live.any():
            return          # wave in flight; next wave starts once it drains
        wave_len = None
        wave_temp = _UNSET = object()
        for r in self.reqs:     # continuous: the live slots' temperature
            if r is not None:   # holds the next chunk too
                wave_temp = r.temperature
        free = [s for s in range(self.B) if not self.live[s]]
        mid_flight = bool((self.live & self.ran).any())
        while free and self.waiting:
            req = self.waiting[0]
            if req.cancelled:
                self.waiting.pop(0)
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                continue
            ids = self.e.tok.encode(req.prompt, bos=True)
            ids = ids[: self.e.max_len - req.max_new - 1]
            if (not self.continuous and wave_len is not None
                    and len(ids) != wave_len):
                break       # different prompt length -> opens the next wave
            if wave_temp is not _UNSET and req.temperature != wave_temp:
                break       # decode runs ONE temperature per chunk, so a
            #                 wave admits only same-temperature requests
            self.waiting.pop(0)
            wave_temp = req.temperature
            if wave_len is None:
                self.waves += 1
            wave_len = len(ids)
            slot = free.pop(0)
            self.admitted += 1
            self.slot_uses[slot] += 1
            ts = trace.start()
            if ts is not None and req.t_queued:
                trace.add("decode.queue", req.t_queued, ts[0], rid=req.rid)
            logits, one_cache = self.e._prefill(self.e.tokens(ids))
            self.e._write_slot(self.cache, one_cache, slot)
            first = int(torch.argmax(logits[0, -1]))
            if ts is not None:
                trace.end(ts, "admission.prefill", rid=req.rid,
                          prompt_len=len(ids), mid_flight=mid_flight)
            req.out_ids.append(first)
            req.slot = slot
            self.token[slot, 0] = first
            self.live[slot] = True
            self.reqs[slot] = req
            self.pos[slot] = self.cache_len = wave_len - 1
        if self.continuous and self.live.any():
            self.cache_len = round(float(self.pos[self.live].mean()))

    def _retire(self):
        for slot in range(self.B):
            r = self.reqs[slot]
            if r is None:
                continue
            if (r.cancelled or len(r.out_ids) >= r.max_new
                    or (r.out_ids and r.out_ids[-1] == EOS)):
                r.done = True
                r.t_done = time.perf_counter()
                self.finished.append(r)
                self.reqs[slot] = None
                self.live[slot] = False

    def step_chunk(self):
        self._admit()
        ts = trace.start()
        self._retire()
        if not self.live.any():
            return False
        temps = [r.temperature for r in self.reqs if r is not None]
        temp = temps[0] if temps and temps[0] is not None else None
        live = torch.from_numpy(self.live.copy()).to(self.e.device)
        if self.continuous:
            # each live slot at its own position; a dead one writes (and
            # puts back) its row at 0
            at = torch.from_numpy(np.where(self.live, self.pos + 1, 0))
            self.token, self.cache, _, toks = self.e._decode_chunk(
                self.token, self.cache, at.to(self.e.device), self.generator,
                temp, live, mean_len=self.cache_len + 1)
            self.pos[self.live] += self.e.chunk
            self.cache_len = round(float(self.pos[self.live].mean()))
        else:
            self.token, self.cache, self.cache_len, toks = \
                self.e._decode_chunk(self.token, self.cache,
                                     self.cache_len + 1, self.generator, temp,
                                     live)
            self.cache_len -= 1
        self.ran = self.live.copy()
        toks = toks.cpu().numpy()
        kept = None if ts is None else {}     # tokens kept per rid
        for slot in range(self.B):
            r = self.reqs[slot]
            if r is None:
                continue
            r.chunks += 1
            n = len(r.out_ids)
            for t in toks[slot]:
                if len(r.out_ids) >= r.max_new:
                    break
                r.out_ids.append(int(t))
                if t == EOS:    # kept, so ``_retire`` sees it
                    break
            if kept is not None:
                kept[r.rid] = len(r.out_ids) - n
        self._retire()
        if ts is not None:
            trace.end(ts, "decode.chunk", slots=self.B, steps=self.e.chunk,
                      tokens=kept)
        return True

    def run_to_completion(self, max_chunks=1000):
        for _ in range(max_chunks):
            self._admit()
            if not self.step_chunk() and not self.waiting:
                break
        return self.finished


# ---------------------------------------------------------------------------
# Batch session API (used by core.runtime.BatchedRuntime)
# ---------------------------------------------------------------------------


class BatchSession:
    """A batch of prompts decoded together with per-request cancellation —
    the batched analogue of ``Session``. ``cancel(i)`` is the StorInfer
    termination signal for prompt ``i``; it takes effect at the next chunk
    boundary (or before prefill if the request is still waiting)."""

    def __init__(self, engine: Engine, prompts: Sequence[str], *,
                 max_new=32, temperature=None, batch_size: int = None):
        self.n = len(prompts)
        slots = min(self.n, batch_size) if batch_size else self.n
        self.sched = BatchScheduler(engine, batch_size=max(slots, 1))
        per_req_max = (list(max_new) if isinstance(max_new, (list, tuple))
                       else [max_new] * self.n)
        self.reqs = [Request(rid=i, prompt=p, max_new=per_req_max[i],
                             temperature=temperature)
                     for i, p in enumerate(prompts)]
        for r in self.reqs:
            self.sched.submit(r)
        self.decode_s = 0.0
        self.chunks_run = 0

    @property
    def done(self) -> bool:
        return len(self.sched.finished) >= self.n

    def cancel(self, i: int):
        self.sched.cancel(i)

    def admit(self):
        """Prefill the next wave into free slots now (``step_chunk`` does
        it otherwise), so that ``decode_s`` then times decode alone."""
        self.sched._admit()

    def step_chunk(self):
        if self.done:
            return
        t0 = time.perf_counter()
        self.sched._admit()
        if self.sched.step_chunk():
            self.chunks_run += 1
        self.decode_s += time.perf_counter() - t0

    def run(self, max_chunks: int = 10000) -> List[Request]:
        for _ in range(max_chunks):
            if self.done:
                break
            self.step_chunk()
        return self.results()

    def results(self) -> List[Request]:
        return sorted(self.sched.finished, key=lambda r: r.rid)

    def text(self, i: int) -> str:
        return self.sched.e.tok.decode(self.reqs[i].out_ids)
