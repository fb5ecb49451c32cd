"""The reference's call forms in the port, held to the reference on the
CPU (reduced configs, the reference's weights copied in):

* ``Engine(cfg, params, tokenizer, run, max_len, chunk)``: the ``RunCfg``
  reaches prefill and decode, through ``Session`` and ``BatchScheduler``,
  including the seq-sharded decode over a (1, 4) CPU mesh;
* ``count_params``, ``serve_step`` and ``sharded_mips_topk``'s
  ``local_scan`` hook;
* ``prefill(cfg, params, batch, run, max_len)`` with the reference's
  batch dict (custom ``positions``, ``frames``, ``mrope_positions``),
  ``decode_step(..., cache_len, run, mrope_positions)``,
  ``lm_logits(cfg, run, params, x)`` and ``embed_tokens``'s ``dtype``;
* the plain helpers ``layers.gqa_scores_softmax_out``, ``causal_mask``,
  ``attention``, ``cross_attention``, ``mla.mla_attention``,
  ``mla.mla_decode``, ``model.attn_fullseq`` and ``model.apply_moe``.
  The reference's ``layers.attention`` with a ``kv_cache`` and its
  ``mla.mla_decode`` raise (a mask of one rank too many): the port's are
  held to the reference's model-level decode, which computes the same.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _eos_reference import EosEngine
from repro.configs import get_config, reduced
from repro.core.kb import build_kb
from repro.core.tokenizer import Tokenizer
from repro.distributed.topk import sharded_mips_topk as j_sharded_topk
from repro.models import layers as JL
from repro.models import mla as JMla
from repro.models import model as M
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.tokenizer import Tokenizer as TTokenizer
from repro_torch.distributed.topk import sharded_mips_topk
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMla
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, tree_map
from repro_torch.serving import engine as TE

RUN = M.RunCfg(attn_impl="naive", remat=False)
TRUN = TM.RunCfg(attn_impl="naive", remat=False)
PROMPTS = ["what is the height of aurora bridge?",
           "who founded the meridian institute?",
           "zebra xylophone never stored anywhere at all"]
TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@functools.lru_cache(maxsize=None)
def _model(arch, **kw):
    """(cfg, params, port cfg, port params) of the reduced arch, two
    layers, f32."""
    kw.setdefault("n_layers", 2)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **kw)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, params, tcfg, params_from_jax(_np(params), device="cpu")


@functools.lru_cache(maxsize=None)
def _engines():
    """The reference engine (the port's EOS rule) and the port's, each in
    the reference's call form, on the reduced qwen3-1.7b."""
    texts = [d.text() for d in build_kb("squad", n_docs=4).docs]
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    cfg, params, tcfg, tparams = _model("qwen3-1.7b",
                                        vocab_size=tok.vocab_size)
    ref = EosEngine(cfg, params, tok, RUN, max_len=32, chunk=4)
    ttok = TTokenizer.from_texts(texts, max_vocab=512)
    port = TE.Engine(tcfg, tparams, ttok, TRUN, max_len=32, chunk=4)
    return ref, port, tparams, ttok


def _ids(engine, prompt, max_new=12):
    s = engine.start_session(prompt, max_new=max_new)
    while not s.done:
        s.step_chunk()
    return s.out_ids


def test_engine_takes_the_reference_runcfg():
    """``Engine(cfg, params, tok, RunCfg(attn_impl="naive", remat=False),
    max_len=32, chunk=4)`` decodes greedily token for token as the
    reference engine does, the run reaching prefill and decode."""
    ref, port, _, _ = _engines()
    assert port.run is TRUN and port.max_len == 32 and port.chunk == 4
    for p in PROMPTS:
        assert _ids(port, p) == _ids(ref, p)


def _sched_ids(engine):
    sched = TE.BatchScheduler(engine, batch_size=2)
    for i, p in enumerate(PROMPTS):
        sched.submit(TE.Request(rid=i, prompt=p, max_new=10))
    return {r.rid: r.out_ids for r in sched.run_to_completion()}


def test_engine_and_scheduler_decode_seq_sharded_over_a_mesh():
    """A ``RunCfg(decode_attn="seq_sharded", mesh=<(1, 4) CPU mesh>)``
    through the ``Engine`` (``Session``) and through ``BatchScheduler``
    (waves written into a seq-sharded cache) gives the tokens of one
    device. The batched cache is f32 here: on a bf16 cache the two decode
    attentions round the probabilities at different points (ROADMAP C,
    "B3 rounding"), which can flip a greedy pick at a near-tie."""
    _, port, tparams, ttok = _engines()
    cfg = dataclasses.replace(port.cfg, dtype="float32")
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    seq = TE.Engine(cfg, tparams, ttok,
                    TM.RunCfg(decode_attn="seq_sharded", mesh=mesh),
                    max_len=32, chunk=4)
    one = TE.Engine(cfg, tparams, ttok, max_len=32, chunk=4)
    for p in PROMPTS:
        assert _ids(seq, p) == _ids(one, p)
    got = _sched_ids(seq)
    assert got == _sched_ids(one) and len(got) == len(PROMPTS)


def test_count_params_is_the_reference_count():
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b", "zamba2-1.2b"):
        _, params, _, tparams = _model(arch)
        assert TM.count_params(tparams) == M.count_params(params)


def _decode_inputs(arch, S=6, M_=12):
    cfg, params, tcfg, tparams = _model(arch)
    tokens = np.random.default_rng(0).integers(
        4, cfg.vocab_size, (2, S)).astype(np.int32)
    _, cache = M.prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, RUN,
                         max_len=M_)
    _, tcache = TM.prefill(tcfg, tparams, {"tokens": _t(tokens).long()},
                           TRUN, max_len=M_)
    return cfg, params, tcfg, tparams, tokens, cache, tcache


def test_serve_step_greedy_matches_reference():
    """``serve_step(cfg, params, token, cache, cache_len, rng, run)``:
    five greedy steps token for token."""
    cfg, params, tcfg, tparams, tokens, cache, tcache = \
        _decode_inputs("qwen3-1.7b")
    tok = jnp.asarray(tokens[:, -1:])
    ttok = _t(tokens[:, -1:]).long()
    for i in range(5):
        tok, cache = M.serve_step(cfg, params, tok, cache,
                                  jnp.asarray(6 + i, jnp.int32),
                                  jax.random.PRNGKey(i), RUN)
        ttok, tcache = TM.serve_step(tcfg, tparams, ttok, tcache, 6 + i,
                                     None, TRUN)
        assert ttok.shape == (2, 1)
        assert np.array_equal(ttok.numpy(), np.asarray(tok))


def test_serve_step_samples_in_distribution():
    """A sampled step (``temperature`` > 0, a ``torch.Generator``): the
    same generator seed gives the same tokens, and over 4,000 rows that
    share one context the top token's frequency is its softmax
    probability within five standard deviations."""
    _, _, tcfg, tparams = _model("qwen3-1.7b")
    N, T = 4000, 0.5
    tokens = torch.full((N, 4), 7, dtype=torch.long)
    lg, cache = TM.prefill(tcfg, tparams, tokens, TRUN, max_len=6)
    step = torch.full((N, 1), 9, dtype=torch.long)
    want, _ = TM.decode_step(tcfg, tparams, step,
                             {k: v.clone() for k, v in cache.items()}, 4,
                             TRUN)
    probs = torch.softmax(want[0, -1].float() / T, -1)
    draws = []
    for _ in range(2):
        nxt, _ = TM.serve_step(tcfg, tparams, step,
                               {k: v.clone() for k, v in cache.items()}, 4,
                               torch.Generator().manual_seed(3), TRUN,
                               temperature=T)
        draws.append(nxt[:, 0])
    assert torch.equal(draws[0], draws[1])
    top = int(torch.argmax(probs))
    p = float(probs[top])
    freq = float((draws[0] == top).float().mean())
    assert abs(freq - p) <= 5 * (p * (1 - p) / N) ** 0.5, (freq, p)


def test_sharded_topk_local_scan_hook():
    """``local_scan=`` replaces the float path's shard scan: called once
    per shard on that shard's real rows only (the padded rows stay
    masked by global id), and the global top-k is the reference's."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    seen = []

    def scan(q, e, k):
        seen.append(e.shape[0])
        v, i = torch.topk(q @ e.T, k)
        return v, i.int()

    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    padded = np.concatenate([emb, np.zeros((4, 16), np.float32)])
    v, i = sharded_mips_topk(_t(q), _t(padded), 5, mesh=mesh,
                             local_scan=scan, n_real=40)
    assert seen == [11, 11, 11, 7]
    jmesh = jax.make_mesh((1,), ("model",))
    jv, ji = j_sharded_topk(
        jnp.asarray(q), jnp.asarray(emb), 5, mesh=jmesh,
        local_scan=lambda q, e, k: jax.lax.top_k(q @ e.T, k))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    _close(v, jv, 1e-5)


# ---------------------------------------------------------------------------
# prefill / decode_step / lm_logits / embed_tokens in the reference's forms
# ---------------------------------------------------------------------------


def _family_batch(cfg, tokens):
    rng = np.random.default_rng(1)
    B, S = tokens.shape
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1] += 1
        batch["mrope_positions"] = pos
    return batch


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "whisper-base", "qwen2-vl-72b"])
def test_prefill_and_decode_step_take_the_reference_forms(arch):
    """``prefill(cfg, params, batch, run, max_len=)`` with the reference's
    batch dict and ``decode_step(cfg, params, token, cache, cache_len,
    run, mrope_positions)`` with ``run`` by position: logits and caches
    as the reference's, for a dense, a moe (MLA), an encdec and a vlm
    config."""
    cfg, params, tcfg, tparams = _model(arch)
    S, M_ = 6, 10
    tokens = np.random.default_rng(0).integers(
        4, cfg.vocab_size, (2, S)).astype(np.int32)
    batch = _family_batch(cfg, tokens)
    lg, cache = M.prefill(cfg, params, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, RUN, max_len=M_)
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v)
          for k, v in batch.items()}
    tlg, tcache = TM.prefill(tcfg, tparams, tb, TRUN, max_len=M_)
    _close(tlg, lg)
    for n in cache:
        _close(tcache[n], cache[n])
    tok = tokens[:, -1:]
    mrope = None if cfg.rope_kind != "mrope" else \
        np.full((3, 2, 1), S + 1, np.int32)
    lg, cache = M.decode_step(cfg, params, jnp.asarray(tok), cache,
                              jnp.asarray(S, jnp.int32), RUN,
                              None if mrope is None else jnp.asarray(mrope))
    tlg, tcache = TM.decode_step(tcfg, tparams, _t(tok).long(), tcache, S,
                                 TRUN, None if mrope is None
                                 else _t(mrope).long())
    _close(tlg, lg)
    for n in cache:
        _close(tcache[n], cache[n])


def test_prefill_honours_custom_positions():
    """A left-padded batch with its own ``positions`` (each row counts
    from its first real token): the reference's logits and cache."""
    cfg, params, tcfg, tparams = _model("qwen3-1.7b")
    tokens = np.random.default_rng(2).integers(
        4, cfg.vocab_size, (2, 7)).astype(np.int32)
    tokens[1, :3] = 0
    pos = np.stack([np.arange(7), np.maximum(np.arange(7) - 3, 0)]) \
        .astype(np.int32)
    lg, cache = M.prefill(cfg, params, {"tokens": jnp.asarray(tokens),
                                        "positions": jnp.asarray(pos)},
                          RUN, max_len=9)
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": _t(tokens).long(),
                                             "positions": _t(pos).long()},
                             TRUN, max_len=9)
    _close(tlg, lg)
    for n in cache:
        _close(tcache[n], cache[n])
    plain, _ = TM.prefill(tcfg, tparams, _t(tokens).long(), TRUN)
    assert not torch.allclose(plain[1], tlg[1])


def test_lm_logits_and_embed_tokens_take_the_reference_order():
    """``lm_logits(cfg, run, params, x)`` (bf16 params, f32 logits under
    ``logits_f32``) and ``embed_tokens(cfg, params, tokens, dtype)``."""
    cfg, params, tcfg, tparams = _model("storinfer-paper-8b")
    x = np.random.default_rng(3).normal(size=(2, 3, cfg.d_model)) \
        .astype(np.float32)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    tp16 = tree_map(lambda t: t.to(torch.bfloat16), tparams)
    want = M.lm_logits(cfg, M.RunCfg(logits_f32=True), p16,
                       jnp.asarray(x, jnp.bfloat16))
    got = TM.lm_logits(tcfg, TM.RunCfg(logits_f32=True), tp16,
                       _t(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 2e-2)
    _close(TM.lm_logits(tcfg, TRUN, tparams, _t(x)),
           M.lm_logits(cfg, RUN, params, jnp.asarray(x)))
    ids = np.array([[1, 5, 9]], np.int32)
    _close(TM.embed_tokens(tcfg, tparams, _t(ids).long(), torch.float32),
           M.embed_tokens(cfg, params, jnp.asarray(ids), jnp.float32), 0.0)


# ---------------------------------------------------------------------------
# The plain helpers
# ---------------------------------------------------------------------------


def test_scores_softmax_out_and_causal_mask():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 6)).astype(np.float32)
    mask = rng.random((2, 1, 1, 5, 7)) > 0.3
    mask[..., 0] = True
    _close(TL.gqa_scores_softmax_out(_t(q), _t(k), _t(v), _t(mask), 0.3),
           JL.gqa_scores_softmax_out(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask), 0.3),
           1e-5)
    for S, T, off in ((5, 5, 0), (3, 7, 4), (4, 2, 1)):
        assert np.array_equal(TL.causal_mask(S, T, off).numpy(),
                              np.asarray(JL.causal_mask(S, T, off)))
    _close(TL.gqa_scores_softmax_out(_t(q), _t(k), _t(v), None, 0.3),
           JL.gqa_scores_softmax_out(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), None, 0.3), 1e-5)


def test_attention_and_cross_attention_match_reference():
    """``layers.attention`` (prefill at mask offsets 0 and 2; decode over a
    ``kv_cache`` dict, held to the reference's ``model.gqa_decode``, since
    the reference's own decode branch raises) and ``cross_attention``."""
    cfg, params, tcfg, tparams = _model("qwen3-1.7b")
    p = params["blocks"]
    jp = jax.tree_util.tree_map(lambda a: a[0], p["attn"])
    tp = tparams["blocks"][0]["attn"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    for off in (0, 2):
        out, kv = JL.attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               mask_offset=off)
        tout, tkv = TL.attention(tcfg, tp, _t(x), _t(pos).long(),
                                 mask_offset=off)
        _close(tout, out)
        _close(tkv["k"], kv["k"])
    hd = cfg.resolved_head_dim
    kc = rng.normal(size=(2, 8, cfg.n_kv_heads, hd)).astype(np.float32)
    vc = rng.normal(size=(2, 8, cfg.n_kv_heads, hd)).astype(np.float32)
    cache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    with pytest.raises(ValueError):
        JL.attention(cfg, jp, jnp.asarray(x[:, :1]), jnp.asarray(pos[:, :1]),
                     kv_cache=cache, cache_len=3)
    want, wk, wv = M.gqa_decode(cfg, RUN, jp, jnp.asarray(x[:, :1]),
                                cache["k"], cache["v"], 3)
    tcache = {"k": _t(kc), "v": _t(vc)}
    got, back = TL.attention(tcfg, tp, _t(x[:, :1]),
                             torch.full((2, 1), 3), kv_cache=tcache,
                             cache_len=3)
    assert back is tcache
    _close(got, want)
    _close(tcache["k"], wk)
    _close(tcache["v"], wv)
    wcfg, wparams, wtcfg, wtparams = _model("whisper-base")
    jx = jax.tree_util.tree_map(lambda a: a[0], wparams["blocks"]["xattn"])
    enc = rng.normal(size=(2, wcfg.encoder_seq, wcfg.d_model)) \
        .astype(np.float32)
    xd = rng.normal(size=(2, 3, wcfg.d_model)).astype(np.float32)
    _close(TL.cross_attention(wtcfg, wtparams["blocks"][0]["xattn"], _t(xd),
                              _t(enc)),
           JL.cross_attention(wcfg, jx, jnp.asarray(xd), jnp.asarray(enc)))


def test_mla_helpers_match_reference():
    """``mla.mla_attention`` against the reference's, and the cache-dict
    ``mla.mla_decode`` against the reference's ``model.mla_decode`` (the
    reference's own ``mla.mla_decode`` raises)."""
    cfg, params, tcfg, tparams = _model("deepseek-v2-lite-16b")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    for off in (0, 3):
        out, kv = JMla.mla_attention(cfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos), mask_offset=off)
        tout, tkv = TMla.mla_attention(tcfg, tp, _t(x), _t(pos).long(),
                                       mask_offset=off)
        _close(tout, out)
        _close(tkv["ckv"], kv["ckv"])
        _close(tkv["krope"], kv["krope"])
    ckv = rng.normal(size=(2, 8, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(2, 8, cfg.qk_rope_head_dim)).astype(np.float32)
    one = jnp.asarray(x[:, :1])
    with pytest.raises(ValueError):
        JMla.mla_decode(cfg, jp, one, {"ckv": jnp.asarray(ckv),
                                       "krope": jnp.asarray(kr)}, 4,
                        jnp.full((2, 1), 4, jnp.int32))
    want, wc, wk = M.mla_decode(cfg, RUN, jp, one, jnp.asarray(ckv),
                                jnp.asarray(kr), 4)
    tcache = {"ckv": _t(ckv), "krope": _t(kr)}
    got, back = TMla.mla_decode(tcfg, tp, _t(x[:, :1]), tcache, 4,
                                torch.full((2, 1), 4))
    assert back is tcache
    _close(got, want)
    _close(tcache["ckv"], wc)
    _close(tcache["krope"], wk)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_attn_fullseq_and_apply_moe_match_reference(arch):
    """``model.attn_fullseq`` (GQA or MLA by the config) and, for the moe
    config, ``model.apply_moe`` with the scatter and einsum dispatch, each
    with ``run`` as a keyword."""
    cfg, params, tcfg, tparams = _model(arch)
    jb = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    tb = tparams["blocks"][0]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    out, kv = M.attn_fullseq(cfg, RUN, jb["attn"], jnp.asarray(x),
                             jnp.asarray(pos))
    tout, tkv = TM.attn_fullseq(tcfg, tb["attn"], _t(x), _t(pos).long(),
                                run=TRUN)
    _close(tout, out)
    assert set(tkv) == set(kv)
    if cfg.family != "moe":
        return
    for impl in ("scatter", "einsum"):
        y, aux = M.apply_moe(cfg, RUN.replace(moe_impl=impl, moe_group=16),
                             jb["moe"], jnp.asarray(x))
        ty, taux = TM.apply_moe(tcfg, tb["moe"], _t(x),
                                run=TRUN.replace(moe_impl=impl,
                                                 moe_group=16))
        _close(ty, y)
        _close(taux, aux)
