"""The reference engine with the port's end-of-sequence rule, for parity
tests of the port's ``Session`` and ``BatchScheduler``.

The reference's ``Session.step_chunk`` and ``BatchScheduler.step_chunk``
stop taking a chunk's tokens at an EOS but never keep the EOS, so the
``out_ids[-1] == EOS`` test that ends a request never fires: a request
whose EOS falls inside a chunk decodes on and takes the next chunk's
tokens (ROADMAP C4). The port keeps the EOS and stops. The classes here
are the reference's with that one change (the EOS appended, then the
loop left), so the port can be held to them token for token. The
reference package itself is not edited.
"""
import time

import numpy as np

import jax
import jax.numpy as jnp

from repro.core.tokenizer import EOS
from repro.serving import engine as E


def _take(out_ids, toks, max_new):
    """The port's rule: append up to ``max_new``, the EOS included, then
    stop."""
    for t in toks:
        if len(out_ids) >= max_new:
            break
        out_ids.append(int(t))
        if t == EOS:
            break


class EosSession(E.Session):
    """``repro.serving.engine.Session`` keeping a mid-chunk EOS."""

    def step_chunk(self):
        if self.done:
            return
        t0 = time.perf_counter()
        self.rng, sub = jax.random.split(self.rng)
        live = jnp.ones((1,), bool)
        self.token, self.cache, self.cache_len, toks = \
            self.e._decode_chunk(self.e.params, self.token, self.cache,
                                 self.cache_len + 1, sub,
                                 self.temperature, live)
        self.cache_len = self.cache_len - 1
        _take(self.out_ids, np.asarray(toks[0]), self.max_new)
        self.decode_s += time.perf_counter() - t0
        self.chunks_run += 1


class EosBatchScheduler(E.BatchScheduler):
    """``repro.serving.engine.BatchScheduler`` keeping a mid-chunk EOS."""

    def step_chunk(self):
        self._admit()
        self._retire()
        if not self.live.any():
            return False
        self.rng, sub = jax.random.split(self.rng)
        temps = [r.temperature for r in self.reqs if r is not None]
        temp = temps[0] if temps and temps[0] is not None else None
        self.token, self.cache, self.cache_len, toks = self.e._decode_chunk(
            self.e.params, self.token, self.cache, self.cache_len + 1, sub,
            temp, jnp.asarray(self.live))
        self.cache_len = self.cache_len - 1
        toks = np.asarray(toks)
        for slot in range(self.B):
            r = self.reqs[slot]
            if r is None:
                continue
            r.chunks += 1
            _take(r.out_ids, toks[slot], r.max_new)
        self._retire()
        return True


class EosBatchSession(E.BatchSession):
    """``repro.serving.engine.BatchSession`` over ``EosBatchScheduler``."""

    def __init__(self, engine, prompts, **kw):
        super().__init__(engine, prompts, **kw)
        sched = EosBatchScheduler(engine, batch_size=self.sched.B)
        for r in self.reqs:
            sched.submit(r)
        self.sched = sched


class EosEngine(E.Engine):
    """The reference engine whose sessions keep a mid-chunk EOS."""

    def start_session(self, prompt, max_new=32, temperature=None, seed=0):
        return EosSession(self, prompt, max_new, temperature, seed)

    def start_batch_session(self, prompts, *, max_new=32, temperature=None,
                            batch_size=None):
        return EosBatchSession(self, prompts, max_new=max_new,
                               temperature=temperature,
                               batch_size=batch_size)
