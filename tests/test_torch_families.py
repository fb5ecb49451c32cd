"""Parity of the port's moe (deepseek MLA and grok GQA), ssm (mamba2) and
hybrid (zamba2) families with the JAX reference, on the CPU.

The pieces first, on numpy inputs from a seed and reference params copied
in through ``params_from_jax``: the MoE router (ties included), the
capacity dispatch and ``moe_ffn`` with forced capacity drops (the same
(token, k) pairs dropped), MLA's prefill attention and absorbed decode,
the SSD chunked scan over several chunks with and without an entering
state, ``ssm_forward``'s final state (also for a prompt shorter than the
convolution window), ``ssm_decode`` and the ``S % chunk`` refusal. Then
each family's ``reduced()`` arch (the KB tokenizer's vocab, max_len 64,
chunk 4): the configs, the converted params, prefill logits and every
cache leaf within 1e-4, greedy tokens through ``Session`` (f32 cache) and
``BatchScheduler`` (the configs' bf16 cache) with a scripted cancel that
leaves a dead slot while another decodes, and a decode step whose dead
slot keeps every cache row.

The reference's own ``BatchScheduler`` cannot decode an ssm or hybrid
model: its decode chunk is a ``lax.scan`` whose carried ``conv`` leaf
enters in the cache's bf16 and leaves in f32 (``ssm_decode`` widens the
window), which ``lax.scan`` refuses. Those archs' scheduler runs are held
to the reference engine with that one leaf cast back to the cache's dtype
each step (``_CastEngine``), which is what the port's in-place write does.

The reference engines here keep an EOS that falls inside a decode chunk,
as the port does (``_eos_reference.EosEngine``; ROADMAP C4): the
reference's own engine drops it and decodes on, and deepseek's and
mamba2's streams meet one.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _eos_reference import EosBatchScheduler, EosEngine
from repro.configs import get_config, reduced
from repro.core.kb import build_kb
from repro.core.tokenizer import Tokenizer
from repro.models import mla as JMla
from repro.models import model as M
from repro.models import moe as JMoe
from repro.models import ssm as JSsm
from repro.serving import engine as E
from repro_torch.configs import ModelConfig as TModelConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.tokenizer import Tokenizer as TTokenizer
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models import ssm as TSsm
from repro_torch.models.convert import params_from_jax, tree_leaves
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import ServingPipeline

ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b", "mamba2-130m", "zamba2-1.2b"]
MAX_LEN, CHUNK = 64, 4
TOL = 1e-4                   # f32: XLA and torch sum in different orders
PROMPTS = ["what is the height of aurora bridge?",
           "who founded the meridian institute?",
           "tell me the capital of port serrano",
           "what is the founder of lake halcyon?",
           "zebra xylophone never stored anywhere at all"]
RUN = M.RunCfg(attn_impl="naive", remat=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch, **kw):
    """(reference cfg, port cfg), the ``reduced()`` arch with ``kw``."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return cfg, tcfg


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(seed=0, **kw):
    cfg, tcfg = _cfgs("deepseek-v2-lite-16b", **kw)
    p = JMoe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, tcfg, p, params_from_jax(_np(p), device="cpu")


def test_route_matches_reference():
    cfg, tcfg, p, tp = _moe()
    x = np.random.default_rng(0).normal(size=(40, cfg.d_model)) \
        .astype(np.float32)
    w, idx, probs = JMoe.route(cfg, p, jnp.asarray(x))
    tw, tidx, tprobs = TMoe.route(tcfg, tp, _t(x))
    assert np.array_equal(tidx.numpy(), np.asarray(idx))
    _close(tw, w, 1e-6)
    _close(tprobs, probs, 1e-6)


def test_route_breaks_ties_as_top_k():
    """Equal router probabilities: ``lax.top_k`` puts the lower expert
    first, and so must the port (``torch.topk`` promises no order)."""
    cfg, tcfg, p, tp = _moe()
    w = np.array(p["router"]["w"])
    w[:, 5] = w[:, 2]                  # experts 2 and 5 always tie
    w[:, 7] = w[:, 2]
    p = dict(p, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": _t(w)})
    x = np.random.default_rng(1).normal(size=(64, cfg.d_model)) \
        .astype(np.float32)
    _, idx, _ = JMoe.route(cfg, p, jnp.asarray(x))
    _, tidx, _ = TMoe.route(tcfg, tp, _t(x))
    idx = np.asarray(idx)
    assert ((idx == 2) | (idx == 5) | (idx == 7)).any()
    assert np.array_equal(tidx.numpy(), idx)


@pytest.mark.parametrize("n_tokens", [5, 47, 300])
def test_dispatch_slots_match_reference(n_tokens):
    cfg, tcfg, _, _ = _moe()
    idx = np.random.default_rng(n_tokens).integers(
        0, cfg.n_experts, (n_tokens, cfg.experts_per_tok)).astype(np.int32)
    slot, valid, C = JMoe.dispatch_slots(cfg, jnp.asarray(idx), n_tokens)
    tslot, tvalid, tC = TMoe.dispatch_slots(tcfg, _t(idx).long(), n_tokens)
    assert tC == C == TMoe.capacity(tcfg, n_tokens)
    assert np.array_equal(tslot.numpy(), np.asarray(slot))
    assert np.array_equal(tvalid.numpy(), np.asarray(valid))


@pytest.mark.parametrize("factor", [64.0, 0.25])
def test_moe_ffn_matches_reference(factor):
    """The reduced config's capacity factor (64: no drops) and 0.25 over 96
    tokens (C = 8 slots per expert for 24 assignments on average): the
    same (token, k) pairs dropped, outputs and aux loss within 1e-4."""
    cfg, tcfg, p, tp = _moe(moe_capacity_factor=factor)
    x = np.random.default_rng(2).normal(size=(2, 48, cfg.d_model)) \
        .astype(np.float32)
    y, aux = JMoe.moe_ffn(cfg, p, jnp.asarray(x))
    _close(TMoe.moe_ffn(tcfg, tp, _t(x)), y)
    _, idx, probs = JMoe.route(cfg, p, jnp.asarray(x.reshape(96, -1)))
    _, valid, _ = JMoe.dispatch_slots(cfg, idx, 96)
    _, tidx, tprobs = TMoe.route(tcfg, tp, _t(x.reshape(96, -1)))
    _, tvalid, _ = TMoe.dispatch_slots(tcfg, tidx, 96)
    assert np.array_equal(tvalid.numpy(), np.asarray(valid))
    assert (not np.asarray(valid).all()) == (factor < 1)
    _close(TMoe.load_balance_loss(tcfg, tprobs, tidx), aux, 1e-5)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mla():
    cfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    p = JMla.mla_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    return cfg, tcfg, p, params_from_jax(_np(p), device="cpu")


def test_mla_prefill_attention_matches_reference():
    cfg, tcfg, p, tp = _mla()
    B, S = 2, 13
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out, kv = M.mla_fullseq(cfg, RUN, p, jnp.asarray(x), jnp.asarray(pos))
    tout, tkv = TM.mla_fullseq(tcfg, tp, _t(x), _t(pos).long())
    _close(tout, out)
    for n in ("ckv", "krope"):
        assert tuple(tkv[n].shape) == kv[n].shape
        _close(tkv[n], kv[n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_reference(dtype):
    """Over a ragged compressed cache: out and the written cache rows; a
    dead slot (``live`` False) keeps its rows."""
    cfg, tcfg, p, tp = _mla()
    B, T, clen = 2, 20, 11
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, T, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, T, cfg.qk_rope_head_dim)).astype(np.float32)
    jd = jnp.dtype(dtype)
    out, nckv, nkr = M.mla_decode(cfg, RUN, p, jnp.asarray(x),
                                  jnp.asarray(ckv).astype(jd),
                                  jnp.asarray(kr).astype(jd), clen)
    td = getattr(torch, dtype)
    tckv, tkr = _t(ckv).to(td), _t(kr).to(td)
    tout = TM.mla_decode(tcfg, tp, _t(x), tckv, tkr, clen)
    tol = TOL if dtype == "float32" else 1e-2
    _close(tout, out, tol)
    _close(tckv, nckv.astype(jnp.float32), tol)
    _close(tkr, nkr.astype(jnp.float32), tol)
    live = torch.tensor([True, False])
    dckv, dkr = _t(ckv).to(td), _t(kr).to(td)
    dout = TM.mla_decode(tcfg, tp, _t(x), dckv, dkr, clen, live)
    assert torch.equal(dout, tout)          # the dead slot computes its step
    assert torch.equal(dckv[0], tckv[0]) and torch.equal(dkr[0], tkr[0])
    assert torch.equal(dckv[1], _t(ckv).to(td)[1])
    assert torch.equal(dkr[1], _t(kr).to(td)[1])


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ssm():
    cfg, tcfg = _cfgs("mamba2-130m")
    p = JSsm.ssm_init(jax.random.PRNGKey(6), cfg, jnp.float32)
    # A_log, dt_bias, D start at 0/0/1; move them off so every term counts
    rng = np.random.default_rng(7)
    H = cfg.n_ssm_heads
    p = dict(p, A_log=jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32),
             dt_bias=jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32),
             D=jnp.asarray(rng.normal(size=H), jnp.float32),
             conv_b=jnp.asarray(rng.normal(size=p["conv_b"].shape) * 0.1,
                                jnp.float32))
    return cfg, tcfg, p, params_from_jax(_np(p), device="cpu")


def _ssd_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            -np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.3,
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_across_chunks_matches_reference(with_h0):
    """S = 64 in chunks of 16: four chunks, so the inter-chunk recurrence
    runs; H = 4 heads over G = 2 groups."""
    xdt, dA, Bm, Cm = _ssd_inputs(2, 64, 4, 8, 2, 6, 8)
    h0 = np.random.default_rng(9).normal(size=(2, 4, 8, 6)) \
        .astype(np.float32) if with_h0 else None
    y, h = JSsm.ssd_chunked(*(jnp.asarray(a) for a in (xdt, dA, Bm, Cm)), 16,
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TSsm.ssd_chunked(*(_t(a) for a in (xdt, dA, Bm, Cm)), 16,
                              h0=None if h0 is None else _t(h0))
    _close(ty, y)
    _close(th, h)
    one, _ = TSsm.ssd_chunked(*(_t(a) for a in (xdt, dA, Bm, Cm)), 64,
                              h0=None if h0 is None else _t(h0))
    _close(ty, one.numpy())            # exact at any chunking
    seg = torch.exp(TSsm._segsum(_t(dA[0, :16, 0])))
    assert torch.isfinite(seg).all() and (seg.triu(1) == 0).all()


@pytest.mark.parametrize("S", [20, 2])
def test_ssm_forward_final_state_matches_reference(S):
    """Output and final (h, conv) state; S = 2 is shorter than the W - 1 = 3
    conv inputs the state keeps (left-padded with zeros)."""
    cfg, tcfg, p, tp = _ssm()
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)) \
        .astype(np.float32)
    y, (h, conv) = JSsm.ssm_forward(cfg, p, jnp.asarray(x))
    ty, (th, tconv) = TSsm.ssm_forward(tcfg, tp, _t(x))
    _close(ty, y)
    _close(th, h)
    assert tuple(tconv.shape) == conv.shape == (2, cfg.ssm_conv - 1,
                                                tconv.shape[-1])
    _close(tconv, conv)
    if S < cfg.ssm_conv - 1:
        assert (tconv[:, :cfg.ssm_conv - 1 - S] == 0).all()


def test_ssm_decode_matches_reference():
    cfg, tcfg, p, tp = _ssm()
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(3, cfg.n_ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state)).astype(np.float32)
    conv = rng.normal(size=(3, cfg.ssm_conv - 1,
                            cfg.d_inner_ssm + 2 * cfg.ssm_state)) \
        .astype(np.float32)
    y, (nh, nconv) = JSsm.ssm_decode(cfg, p, jnp.asarray(x), jnp.asarray(h),
                                     jnp.asarray(conv))
    ty, (tnh, tnconv) = TSsm.ssm_decode(tcfg, tp, _t(x), _t(h), _t(conv))
    _close(ty, y)
    _close(tnh, nh)
    _close(tnconv, nconv)


def test_ssm_refuses_a_length_past_one_chunk_not_a_multiple():
    """S = 40 with chunks of 16: the reference's ``ssd_chunked`` asserts
    ``S % chunk == 0``; the port raises too (it does not pad)."""
    cfg, tcfg, p, tp = _ssm()
    x = np.zeros((1, 40, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        JSsm.ssm_forward(cfg, p, jnp.asarray(x), chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TSsm.ssm_forward(tcfg, tp, _t(x), chunk=16)
    assert TSsm.ssm_forward(tcfg, tp, _t(x[:, :32]), chunk=16)[0].shape == \
        (1, 32, cfg.d_model)


# ---------------------------------------------------------------------------
# The four families end to end
# ---------------------------------------------------------------------------


class _CastEngine(EosEngine):
    """The reference engine whose decode chunk casts each new cache leaf
    back to the carried leaf's dtype (``conv``: bf16 in the batched cache),
    so that its ``lax.scan`` accepts an ssm or hybrid cache. Otherwise the
    body is ``repro.serving.engine.Engine._decode_chunk_impl``'s."""

    def _decode_chunk_impl(self, params, token, cache, cache_len, rng,
                           temperature, live):
        def body(carry, _):
            tok, cache, clen, rng = carry
            rng, sub = jax.random.split(rng)
            logits, new_cache = M.decode_step(self.cfg, params, tok, cache,
                                              clen, self.run)
            nxt = E.sample_token(logits[:, -1, :], sub, temperature)[:, None]
            nxt = jnp.where(live[:, None], nxt.astype(jnp.int32), tok)
            new_cache = jax.tree_util.tree_map(
                lambda n, o: jnp.where(
                    jnp.reshape(live, (1, -1) + (1,) * (n.ndim - 2)), n,
                    o).astype(o.dtype), new_cache, cache)
            return (nxt, new_cache, clen + 1, rng), nxt[:, 0]

        (tok, cache, clen, _), toks = jax.lax.scan(
            body, (token, cache, cache_len, rng), None, length=self.chunk)
        return tok, cache, clen, jnp.transpose(toks)


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """(reference engine, port engine) on the arch's reduced config, the
    port holding the reference's weights."""
    kb = build_kb("squad", n_docs=4)
    texts = [d.text() for d in kb.docs]
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    cfg, tcfg = _cfgs(arch, vocab_size=tok.vocab_size)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    cls = _CastEngine if cfg.family in ("ssm", "hybrid") else EosEngine
    ref = cls(cfg, params, tok, RUN, max_len=MAX_LEN, chunk=CHUNK)
    port = TE.Engine(tcfg, params_from_jax(_np(params), device="cpu"),
                     TTokenizer.from_texts(texts, max_vocab=512),
                     max_len=MAX_LEN, chunk=CHUNK)
    return ref, port


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _engines(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    full, tfull = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(tfull)
    assert tfull.param_count() == full.param_count()
    assert tfull.active_param_count() == full.active_param_count()
    assert dataclasses.asdict(t_reduced(tfull)) == \
        dataclasses.asdict(reduced(full))
    assert arch in list_configs()


def test_encdec_and_vlm_still_refused():
    """The model API runs both families now (``tests/test_torch_encdec_vlm
    .py``); the serving ``Engine`` still refuses them, since it prefills
    tokens only, as the reference's does."""
    for arch in ("whisper-base", "qwen2-vl-72b"):
        tcfg = TModelConfig(**dataclasses.asdict(reduced(get_config(arch))))
        params = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
        assert set(TM.init_cache(tcfg, 1, 8, device="cpu")) == \
            set(M.cache_struct(reduced(get_config(arch)), 1, 8))
        with pytest.raises(NotImplementedError, match="prefills tokens only"):
            TE.Engine(tcfg, params, None)


def test_converted_params_match_shapes(family):
    """Every reference leaf lands in the port with its shape and numbers:
    ``blocks`` and deepseek's ``dense0`` unstacked layer by layer, zamba2's
    ``shared`` block carried as one layer's dict."""
    ref, port = family
    cfg = port.cfg
    flat = jax.tree_util.tree_leaves(ref.params)
    assert sum(a.size for a in flat) == \
        sum(t.numel() for t in tree_leaves(port.params))
    assert set(port.params) == set(ref.params)
    for key in ("blocks", "dense0"):
        if key not in ref.params:
            continue
        stack = ref.params[key]
        n = jax.tree_util.tree_leaves(stack)[0].shape[0]
        assert len(port.params[key]) == n
        for i in range(n):
            want = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda a: a[i], stack))
            got = list(tree_leaves(port.params[key][i]))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert tuple(g.shape) == w.shape
                assert np.array_equal(g.numpy(), np.asarray(w))
    if cfg.family == "moe":
        assert ("dense0" in port.params) == bool(cfg.first_dense_layers)
        assert len(port.params["blocks"]) == \
            cfg.n_layers - cfg.first_dense_layers
    if cfg.family == "hybrid":
        shared = port.params["shared"]
        assert isinstance(shared, dict) and "attn" in shared
        for g, w in zip(tree_leaves(shared),
                        jax.tree_util.tree_leaves(ref.params["shared"])):
            assert tuple(g.shape) == w.shape
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prompt", PROMPTS[:3])
def test_prefill_logits_and_cache_match(family, prompt):
    ref, port = family
    ids = ref.tok.encode(prompt, bos=True)
    lg, cache = ref._prefill(ref.params, jnp.asarray([ids], jnp.int32))
    tlg, tcache = port._prefill(port.tokens(ids))
    _close(tlg, lg)
    assert set(tcache) == set(cache)
    for name in cache:
        assert tuple(tcache[name].shape) == cache[name].shape, name
        assert tcache[name].dtype == getattr(torch, str(cache[name].dtype))
        _close(tcache[name], cache[name])


def test_cache_struct_matches_reference(family):
    ref, port = family
    want = M.cache_struct(ref.cfg, 3, MAX_LEN)
    got = TM.cache_struct(port.cfg, 3, MAX_LEN)
    assert set(got) == set(want)
    for n, (shape, dt) in got.items():
        assert shape == want[n].shape and dt == getattr(torch,
                                                        str(want[n].dtype))


@pytest.mark.parametrize("prompt", PROMPTS[:3])
def test_greedy_session_tokens_identical(family, prompt):
    ref, port = family
    s = ref.start_session(prompt, max_new=20)
    t = port.start_session(prompt, max_new=20)
    while not s.done:
        s.step_chunk()
    while not t.done:
        t.step_chunk()
    assert t.out_ids == s.out_ids
    assert t.chunks_run == s.chunks_run


def _scripted(mod, engine, sched_cls=None):
    """Submit five requests over two slots, cancel one live and one
    waiting request after the first chunk (the live one's slot decodes on
    dead until the wave drains), and record each chunk's live slots and
    finished requests."""
    sched = (sched_cls or mod.BatchScheduler)(engine, batch_size=2)
    for i, p in enumerate(PROMPTS):
        sched.submit(mod.Request(rid=i, prompt=p, max_new=10 + 4 * i))
    trace = []
    for step in range(40):
        if step == 1:
            sched.cancel(0)
            sched.cancel(4)
        ran = sched.step_chunk()
        trace.append((step, tuple(sched.live.tolist()),
                      tuple((r.rid, r.cancelled, r.slot, tuple(r.out_ids),
                             r.chunks) for r in sched.drain_finished())))
        if not ran and not sched.waiting:
            break
    return trace, sched.waves, sched.slot_uses


def test_batch_scheduler_with_a_dead_slot_identical(family):
    """The configs' bf16 batched cache (``h`` f32): greedy tokens, the
    cancel/retire sequence and slot reuse identical to the reference
    while a cancelled request's slot sits dead beside a live one."""
    ref, port = family
    for n, t in TM.init_cache(port.cfg, 2, MAX_LEN, device="cpu").items():
        assert t.dtype == (torch.float32 if n == "h" else torch.bfloat16)
    got, want = _scripted(TE, port), _scripted(E, ref, EosBatchScheduler)
    assert got == want
    assert any(sum(live) == 1 for _, live, _ in got[0])


def test_reference_scheduler_refuses_ssm_and_hybrid():
    """Why ``_CastEngine`` exists: the reference's own scheduler stops at
    its first decode chunk on an ssm or hybrid model; the port's runs."""
    for arch in ("mamba2-130m", "zamba2-1.2b"):
        ref, port = _engines(arch)
        plain = E.Engine(ref.cfg, ref.params, ref.tok, RUN, max_len=MAX_LEN,
                         chunk=CHUNK)
        sched = E.BatchScheduler(plain, batch_size=2)
        sched.submit(E.Request(rid=0, prompt=PROMPTS[0], max_new=6))
        with pytest.raises(TypeError, match="carry"):
            sched.run_to_completion()
        tsched = TE.BatchScheduler(port, batch_size=2)
        tsched.submit(TE.Request(rid=0, prompt=PROMPTS[0], max_new=6))
        assert len(tsched.run_to_completion()[0].out_ids) == 6


def _picked(engine, slots):
    """Whether the pipeline's decode worker builds a continuous scheduler
    for ``engine`` at ``slots`` (its loop run to the shutdown sentinel)."""
    pipe = ServingPipeline(types.SimpleNamespace(engine=engine),
                           decode_slots=slots)
    pipe._decode_q.put(None)             # the loop builds it, then stops
    pipe._decode_loop({})
    return pipe.scheduler.continuous


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_admits_in_waves(arch):
    """The pipeline's scheduler admits in waves on the MoE models whose
    expert capacity can drop at the slot count (deepseek, with MLA; grok,
    with GQA, at its published capacity factor over 16 slots), ssm and
    hybrid models: a dropping MoE token's experts depend on the other
    rows of its step, and MLA, ssm and hybrid take one position for the
    batch, so ``decode_step`` and a continuous scheduler refuse per-row
    positions there. The reduced grok, whose capacity drops nothing,
    admits continuously."""
    _, port = _engines(arch)
    slots = 16
    if arch == "grok-1-314b":
        assert _picked(port, 2) and TE.decode_rows_independent(port.cfg,
                                                               batch=2)
        cfg = dataclasses.replace(port.cfg, moe_capacity_factor=t_get_config(
            arch).moe_capacity_factor)
        assert TMoe.capacity(cfg, slots) < slots
        port = TE.Engine(cfg, port.params, port.tok, max_len=MAX_LEN,
                         chunk=CHUNK)
    assert not TE.decode_rows_independent(port.cfg)
    assert not TE.decode_rows_independent(port.cfg, batch=slots)
    assert _picked(port, slots) is False
    per_row = TM.per_row_positions(port.cfg)
    assert per_row == (arch == "grok-1-314b")
    if not per_row:
        cache = TM.init_cache(port.cfg, 2, MAX_LEN, device="cpu")
        with pytest.raises(ValueError, match="per-row"):
            TM.decode_step(port.cfg, port.params,
                           torch.ones(2, 1, dtype=torch.long), cache,
                           torch.tensor([3, 5]))
    with pytest.raises(ValueError, match="per-row"):
        TE.BatchScheduler(port, batch_size=slots, continuous=True)


def test_decode_step_keeps_dead_slot_rows(family):
    """One decode step over a prefilled two-slot batch cache with slot 1
    dead: slot 1's rows of every leaf are bitwise unchanged, slot 0's are
    the reference's step (its masked new cache)."""
    ref, port = family
    cache = M.init_cache(ref.cfg, 2, MAX_LEN)
    tcache = TM.init_cache(port.cfg, 2, MAX_LEN, device="cpu")
    clen = None
    for slot, prompt in enumerate(PROMPTS[:2]):
        ids = ref.tok.encode(prompt, bos=True)[:9]
        _, one = ref._prefill(ref.params, jnp.asarray([ids], jnp.int32))
        cache = ref._write_slot(cache, one, slot)
        port._write_slot(tcache, port._prefill(port.tokens(ids))[1], slot)
        clen = len(ids) - 1
    for n in cache:                  # bf16 leaves: an ulp where f32 differ
        _close(tcache[n], cache[n], TOL if n == "h" else 1e-2)
    before = {n: t.clone() for n, t in tcache.items()}
    token = np.array([[7], [11]], np.int32)
    live = np.array([True, False])
    lg, new = M.decode_step(ref.cfg, ref.params, jnp.asarray(token), cache,
                            clen + 1, RUN)
    new = jax.tree_util.tree_map(
        lambda n, o: jnp.where(jnp.reshape(jnp.asarray(live), (1, -1) + (1,)
                                           * (n.ndim - 2)), n,
                               o).astype(o.dtype), new, cache)
    tlg, tnew = TM.decode_step(port.cfg, port.params, _t(token).long(),
                               tcache, clen + 1,
                               live=torch.from_numpy(live))
    assert tnew is tcache
    _close(tlg[0], lg[0], 2e-2)      # bf16 cache entries
    for n in tcache:
        assert torch.equal(tcache[n][:, 1], before[n][:, 1]), n
        assert not torch.equal(tcache[n][:, 0], before[n][:, 0]), n
        _close(tcache[n][:, 0], new[n][:, 0], 1e-2)
