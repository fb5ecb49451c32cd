"""Parity of the port's dense engine (repro_torch.models + serving.engine)
with the JAX reference on the EngineCfg smoke arch (qwen3-1.7b reduced,
2 layers, max_len 160, chunk 8), with the reference's weights copied in
through ``params_from_jax``: prefill logits, greedy tokens through
``Session`` (f32 cache) and ``BatchScheduler`` (bf16 cache), and the
cancel/retire sequence of a scripted scheduler run. Everything runs on
the CPU, where the decode-attention wrapper takes its plain version (the
reference engine's naive decode math)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.kb import build_kb
from repro.core.tokenizer import Tokenizer
from repro.models import model as M
from repro.serving import engine as E
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.tokenizer import Tokenizer as TTokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import engine as TE

MAX_LEN, CHUNK = 160, 8
PROMPTS = ["what is the height of aurora bridge?",
           "who founded the meridian institute?",
           "tell me the capital of port serrano",
           "what is the founder of lake halcyon?",
           "zebra xylophone never stored anywhere at all",
           "what is the length of the iron canal?"]


@pytest.fixture(scope="module")
def engines():
    kb = build_kb("squad", n_docs=4)
    texts = [d.text() for d in kb.docs]
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    ref = E.Engine(cfg, params, tok, M.RunCfg(attn_impl="naive", remat=False),
                   max_len=MAX_LEN, chunk=CHUNK)
    tcfg = dataclasses.replace(t_reduced(t_get_config("qwen3-1.7b")),
                               vocab_size=tok.vocab_size, n_layers=2)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    port = TE.Engine(tcfg, tparams, TTokenizer.from_texts(texts,
                                                         max_vocab=512),
                     max_len=MAX_LEN, chunk=CHUNK)
    return ref, port


def test_configs_are_the_reference_configs():
    ref, port = (reduced(get_config("qwen3-1.7b")),
                 t_reduced(t_get_config("qwen3-1.7b")))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    full, tfull = get_config("qwen3-1.7b"), t_get_config("qwen3-1.7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(tfull)
    assert tfull.padded_vocab == full.padded_vocab
    assert tfull.resolved_head_dim == 128


def test_converted_params_match_shapes(engines):
    ref, port = engines
    flat = jax.tree_util.tree_leaves_with_path(ref.params)
    n_ref = sum(int(np.prod(a.shape)) for _, a in flat)
    n_port = sum(t.numel() for t in _leaves(port.params))
    assert n_ref == n_port
    assert len(port.params["blocks"]) == 2
    wq = np.asarray(ref.params["blocks"]["attn"]["wq"]["w"][1])
    assert np.array_equal(port.params["blocks"][1]["attn"]["wq"]["w"].numpy(),
                          wq)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


@pytest.mark.parametrize("prompt", PROMPTS[:3])
def test_prefill_logits_and_cache_match(engines, prompt):
    """XLA and torch sum in different orders: logits within 1e-4."""
    ref, port = engines
    ids = ref.tok.encode(prompt, bos=True)
    lg, cache = ref._prefill(ref.params, jnp.asarray([ids], jnp.int32))
    tlg, tcache = port._prefill(port.tokens(ids))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == cache[name].shape
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("prompt", PROMPTS[:4])
def test_greedy_session_tokens_identical(engines, prompt):
    ref, port = engines
    s = ref.start_session(prompt, max_new=24)
    t = port.start_session(prompt, max_new=24)
    while not s.done:
        s.step_chunk()
    while not t.done:
        t.step_chunk()
    assert t.out_ids == s.out_ids
    assert t.chunks_run == s.chunks_run


def test_greedy_batch_scheduler_tokens_identical(engines):
    """bf16 batched cache, several waves over 3 slots."""
    ref, port = engines
    rs, ts = E.BatchScheduler(ref, batch_size=3), \
        TE.BatchScheduler(port, batch_size=3)
    for i, p in enumerate(PROMPTS):
        rs.submit(E.Request(rid=i, prompt=p, max_new=20))
        ts.submit(TE.Request(rid=i, prompt=p, max_new=20))
    got_r = {r.rid: r.out_ids for r in rs.run_to_completion()}
    got_t = {r.rid: r.out_ids for r in ts.run_to_completion()}
    assert got_t == got_r
    assert (ts.waves, ts.admitted, ts.slot_uses) == \
        (rs.waves, rs.admitted, rs.slot_uses)


def _scripted(mod, engine):
    """Submit, cancel one live and one waiting request mid-run, and record
    (chunk, live slots, finished rids, cancelled flags) per chunk."""
    sched = mod.BatchScheduler(engine, batch_size=2)
    for i, p in enumerate(PROMPTS[:5]):
        sched.submit(mod.Request(rid=i, prompt=p, max_new=12 + 4 * i))
    trace = []
    for step in range(40):
        if step == 1:
            sched.cancel(0)          # live: retires at the next boundary
            sched.cancel(4)          # still waiting: never prefilled
        ran = sched.step_chunk()
        trace.append((step, tuple(sched.live.tolist()),
                      tuple((r.rid, r.cancelled, r.slot, len(r.out_ids),
                             r.chunks) for r in sched.drain_finished())))
        if not ran and not sched.waiting:
            break
    return trace, sched.waves, sched.slot_uses


def test_scripted_cancel_retire_sequence_identical(engines):
    ref, port = engines
    assert _scripted(TE, port) == _scripted(E, ref)


def test_sampled_tokens_follow_the_softmax():
    """Sampling is held by distribution only (jax.random's stream cannot
    be reproduced): frequencies of 20000 draws vs softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TE.sample_token(logits, gen, 0.7)
                         for _ in range(20000)])
    freq = np.bincount(draws.numpy().ravel(), minlength=4) / 20000
    want = torch.softmax(logits / 0.7, -1)[0].numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    assert TE.sample_token(logits, gen, None).item() == 0
