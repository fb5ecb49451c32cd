"""Parity of the port's encdec (whisper-base) and vlm (qwen2-vl-72b,
M-RoPE) families with the JAX reference, on the CPU.

Neither family is served behind the reference's ``Engine`` (it prefills
tokens only: whisper needs ``frames``, qwen2-vl M-RoPE positions), so
both are held to the reference through the model API, as
``tests/test_arch_smoke.py`` drives them: each ``reduced()`` arch with
the reference's weights copied in (``params_from_jax``), numpy inputs
from a seed (random frame embeddings, the reference's stub frontend),
``RunCfg(attn_impl="naive")`` on the reference's side. Checked: the
configs, the converted params, prefill logits and every cache leaf
(``xk``/``xv`` included), greedy tokens over two chunks of decode steps,
``decode_step`` against ``forward`` at the next position, M-RoPE with
t, h and w positions that differ (a text prefix, a 4x4 "image" block and
a text suffix, as Qwen2-VL numbers them), a bf16 cache, which kernel
wrapper each attention goes through, and the engines' refusals.
Tolerances: 1e-4 on f32 (XLA and torch sum in other orders), 1e-2 on
bf16 cache leaves and 2e-2 on logits read through them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.kb import build_kb
from repro.core.tokenizer import Tokenizer
from repro.models import layers as JL
from repro.models import model as M
from repro.serving import engine as E
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
from repro_torch.serving import engine as TE

ARCHS = ["whisper-base", "qwen2-vl-72b"]
RUN = M.RunCfg(attn_impl="naive", remat=False)
TOL, TOL_BF16, TOL_BF16_LOGITS = 1e-4, 1e-2, 2e-2
MAX_LEN, CHUNK, S = 40, 4, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def mrope_layout(B, n_text, grid, n_suffix):
    """(3, B, S) Qwen2-VL positions: a text prefix (t = h = w = i), a grid
    x grid image block at the next position (t fixed, h the row, w the
    column), then text continuing from the largest position + 1."""
    pos = [[i, i, i] for i in range(n_text)]
    for r in range(grid):
        for c in range(grid):
            pos.append([n_text, n_text + r, n_text + c])
    nxt = max(max(p) for p in pos) + 1
    pos += [[nxt + i] * 3 for i in range(n_suffix)]
    return np.broadcast_to(np.asarray(pos, np.int32).T[:, None, :],
                           (3, B, len(pos))).copy()


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, params), (port cfg, params): the reduced arch with
    the KB tokenizer's vocab, the port holding the reference's weights."""
    kb = build_kb("squad", n_docs=4)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=512)
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              vocab_size=tok.vocab_size)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               vocab_size=tok.vocab_size)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, params, tcfg, params_from_jax(_np(params), device="cpu"), tok


def _inputs(cfg, B=2, seq=S, seed=0):
    """(tokens, frames or None, mrope positions or None), numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, cfg.vocab_size, (B, seq)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32) if cfg.is_encoder_decoder else None
    mrope = mrope_layout(B, 3, 2, seq - 7) if cfg.rope_kind == "mrope" \
        else None
    return tokens, frames, mrope


def _ref_batch(tokens, frames, mrope):
    b = {"tokens": jnp.asarray(tokens)}
    if frames is not None:
        b["frames"] = jnp.asarray(frames)
    if mrope is not None:
        b["mrope_positions"] = jnp.asarray(mrope)
    return b


def _port_batch(tokens, frames, mrope):
    """The reference's batch dict for the port's ``prefill``."""
    batch = {"tokens": _t(tokens).long()}
    if frames is not None:
        batch["frames"] = _t(frames)
    if mrope is not None:
        batch["mrope_positions"] = _t(mrope).long()
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return _setup(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    full, tfull = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(tfull)
    assert tfull.param_count() == full.param_count()
    assert dataclasses.asdict(t_reduced(tfull)) == \
        dataclasses.asdict(reduced(full))
    assert arch in list_configs()


def test_converted_params_round_trip(family):
    """Every reference leaf lands in the port (whisper's ``enc_blocks``
    unstacked like ``blocks``, ``enc_norm``, the decoder's ``lnx`` and
    ``xattn``), and ``params_to_numpy`` gives back the reference's
    pytree bit for bit."""
    cfg, params, tcfg, tparams, _ = family
    assert set(tparams) == set(params)
    assert sum(a.size for a in jax.tree_util.tree_leaves(params)) == \
        sum(t.numel() for t in tree_leaves(tparams))
    if cfg.is_encoder_decoder:
        assert len(tparams["enc_blocks"]) == cfg.n_encoder_layers
        assert {"lnx", "xattn"} <= set(tparams["blocks"][0])
    back = params_to_numpy(tparams)
    want = jax.tree_util.tree_flatten_with_path(_np(params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, w in want:
        assert got[path].shape == w.shape and np.array_equal(got[path], w)


def test_port_init_matches_reference_shapes(family):
    cfg, params, tcfg, _, _ = family
    own = params_to_numpy(TM.init_model(tcfg, torch.Generator()
                                        .manual_seed(0), dtype="float32",
                                        device="cpu"))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(_np(params))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_logits_and_every_cache_leaf_match(family, seed):
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=seed)
    lg, cache = M.prefill(cfg, params, _ref_batch(tokens, frames, mrope),
                          RUN, max_len=MAX_LEN)
    tlg, tcache = TM.prefill(
        tcfg, tparams, _port_batch(tokens, frames, mrope), max_len=MAX_LEN)
    _close(tlg, lg)
    assert set(tcache) == set(cache) == set(TM.cache_struct(tcfg, 2,
                                                            MAX_LEN))
    for n, (shape, dt) in TM.cache_struct(tcfg, 2, MAX_LEN).items():
        assert tuple(tcache[n].shape) == cache[n].shape == shape, n
        _close(tcache[n], cache[n])
    if cfg.is_encoder_decoder:
        assert tcache["xk"].shape[2] == cfg.encoder_seq


def _ref_greedy(cfg, params, tokens, frames, mrope, n):
    lg, cache = M.prefill(cfg, params, _ref_batch(tokens, frames, mrope),
                          RUN, max_len=MAX_LEN)
    out = [np.asarray(jnp.argmax(lg[:, -1], -1))]
    clen = tokens.shape[1]
    for _ in range(n - 1):
        lg, cache = M.decode_step(cfg, params, jnp.asarray(out[-1][:, None]),
                                  cache, jnp.asarray(clen, jnp.int32), RUN)
        out.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
        clen += 1
    return np.stack(out, 1)


def _port_greedy(tcfg, tparams, tokens, frames, mrope, n, chunk=CHUNK):
    """Prefill, then decode in chunks of ``chunk`` steps (the engine's
    structure), greedy."""
    lg, cache = TM.prefill(
        tcfg, tparams, _port_batch(tokens, frames, mrope), max_len=MAX_LEN)
    out = [torch.argmax(lg[:, -1], -1)]
    clen = tokens.shape[1]
    while len(out) < n:
        for _ in range(min(chunk, n - len(out))):
            lg, cache = TM.decode_step(tcfg, tparams, out[-1][:, None], cache,
                                       clen)
            out.append(torch.argmax(lg[:, -1], -1))
            clen += 1
    return torch.stack(out, 1).numpy()


def test_greedy_tokens_over_two_chunks_identical(family):
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=2)
    n = 2 * CHUNK + 1
    want = _ref_greedy(cfg, params, tokens, frames, mrope, n)
    got = _port_greedy(tcfg, tparams, tokens, frames, mrope, n)
    assert got.shape == (2, n)
    assert np.array_equal(got, want)


def test_decode_step_matches_forward_at_the_next_position(family):
    """Prefill S - 1 tokens, decode token S - 1: its logits are the full
    forward's at S - 1 (the reference's check, ``test_arch_smoke.py``),
    in the port and against the reference's forward. Decode's M-RoPE
    position is ``cache_len`` on all three streams, so the forward gets
    the same there."""
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=3)
    if mrope is not None:
        mrope[:, :, -1] = S - 1
    full, _ = M.forward(cfg, params, _ref_batch(tokens, frames, mrope), RUN)
    tfull, aux = TM.forward(tcfg, tparams, _port_batch(tokens, frames, mrope),
                            TM.RunCfg(attn_impl="naive"))
    _close(tfull, full)
    assert float(aux["moe_aux"]) == 0.0
    _, cache = TM.prefill(tcfg, tparams, _port_batch(
        tokens[:, :-1], frames, None if mrope is None else mrope[:, :, :-1]),
        max_len=MAX_LEN)
    lg, _ = TM.decode_step(tcfg, tparams, _t(tokens[:, -1:]).long(), cache,
                           S - 1)
    _close(lg[:, 0], tfull[:, S - 1])
    _close(lg[:, 0], full[:, S - 1])


def test_mrope_with_distinct_streams_matches_reference():
    """``apply_mrope`` with t != h != w (the image block), each section of
    the frequency slots driven by its own stream, and the whole model's
    prefill and one decode step given an explicit next position."""
    rng = np.random.default_rng(4)
    pos = mrope_layout(2, 3, 4, 5)
    assert len({tuple(p) for p in pos[:, 0].T}) == pos.shape[-1]
    assert (pos[0, 0] != pos[1, 0]).any() and (pos[1, 0] != pos[2, 0]).any()
    x = rng.normal(size=(2, pos.shape[-1], 4, 16)).astype(np.float32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
    _close(TL.apply_mrope(_t(x), _t(pos).long(), 1e6, (4, 2, 2)), want, 1e-5)
    # each stream moves only its own section's slots
    for stream, (lo, hi) in enumerate(((0, 4), (4, 6), (6, 8))):
        p2 = pos.copy()
        p2[stream] += 5
        d = (TL.apply_mrope(_t(x), _t(p2).long(), 1e6, (4, 2, 2))
             - TL.apply_mrope(_t(x), _t(pos).long(), 1e6, (4, 2, 2))).abs()
        moved = (d.amax(dim=(0, 1, 2)) > 0).numpy()
        assert moved[lo:hi].all() and moved[8 + lo:8 + hi].all()
        assert not np.delete(moved, list(range(lo, hi)) +
                             list(range(8 + lo, 8 + hi))).any()
    cfg, params, tcfg, tparams, _ = _setup("qwen2-vl-72b")
    tokens = rng.integers(4, cfg.vocab_size, (2, pos.shape[-1])) \
        .astype(np.int32)
    lg, cache = M.prefill(cfg, params, _ref_batch(tokens, None, pos), RUN,
                          max_len=MAX_LEN)
    tlg, tcache = TM.prefill(tcfg, tparams,
                             {"tokens": _t(tokens).long(),
                              "mrope_positions": _t(pos).long()},
                             max_len=MAX_LEN)
    _close(tlg, lg)
    for n in cache:
        _close(tcache[n], cache[n])
    nxt = np.full((3, 2, 1), pos.max() + 1, np.int32)
    clen = pos.shape[-1]
    lg, _ = M.decode_step(cfg, params, jnp.asarray(tokens[:, :1]), cache,
                          jnp.asarray(clen, jnp.int32), RUN,
                          mrope_positions=jnp.asarray(nxt))
    tlg, _ = TM.decode_step(tcfg, tparams, _t(tokens[:, :1]).long(), tcache,
                            clen, mrope_positions=_t(nxt).long())
    _close(tlg, lg)


def test_bf16_cache_decode_matches_reference(family):
    """The prefill cache cast into a bf16 cache (as a batch scheduler's
    would be), then two decode steps on each side."""
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=5)
    _, cache = M.prefill(cfg, params, _ref_batch(tokens, frames, mrope), RUN,
                         max_len=MAX_LEN)
    cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), cache)
    _, tcache = TM.prefill(
        tcfg, tparams, _port_batch(tokens, frames, mrope), max_len=MAX_LEN)
    tcache = {n: t.to(torch.bfloat16) for n, t in tcache.items()}
    tok = tokens[:, -1:]
    for i in range(2):
        lg, cache = M.decode_step(cfg, params, jnp.asarray(tok), cache,
                                  jnp.asarray(S + i, jnp.int32), RUN)
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(tok).long(), tcache,
                                     S + i)
        _close(tlg, lg, TOL_BF16_LOGITS)
        for n in cache:
            assert tcache[n].dtype == torch.bfloat16
            _close(tcache[n], cache[n].astype(jnp.float32), TOL_BF16)
        tok = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]


def test_decode_past_the_cache_end_clamps_as_the_reference(family):
    """A decode step at ``cache_len`` past the last slot writes the last
    slot and (whisper) reads the last sinusoidal row, as the reference's
    clamping update and slice do."""
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=6)
    _, cache = M.prefill(cfg, params, _ref_batch(tokens, frames, mrope), RUN,
                         max_len=S + 2)
    _, tcache = TM.prefill(
        tcfg, tparams, _port_batch(tokens, frames, mrope), max_len=S + 2)
    lg, cache = M.decode_step(cfg, params, jnp.asarray(tokens[:, :1]), cache,
                              jnp.asarray(S + 5, jnp.int32), RUN)
    tlg, tcache = TM.decode_step(tcfg, tparams, _t(tokens[:, :1]).long(),
                                 tcache, S + 5)
    _close(tlg, lg)
    for n in cache:
        _close(tcache[n], cache[n])


def _counting(monkeypatch):
    calls = {"flash_attention": [], "decode_attention": []}
    for name in calls:
        real = getattr(ops, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls[_name].append(tuple(a[1].shape))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, wrap)
    return calls


def test_every_attention_goes_through_the_kernel_wrappers(family,
                                                          monkeypatch):
    """Prefill: each encoder layer (non-causal, T = encoder_seq), each
    decoder self-attention and cross-attention (T = encoder_seq) call
    ``ops.flash_attention`` (B4 on a CUDA tensor); a decode step calls
    ``ops.decode_attention`` (B3) for the self-attention and, whisper, for
    the cross-attention over the static ``xk``/``xv``."""
    cfg, params, tcfg, tparams, _ = family
    tokens, frames, mrope = _inputs(cfg, seed=7)
    calls = _counting(monkeypatch)
    _, cache = TM.prefill(
        tcfg, tparams, _port_batch(tokens, frames, mrope), max_len=MAX_LEN)
    Te = cfg.encoder_seq
    if cfg.is_encoder_decoder:
        want = [(2, Te, cfg.n_kv_heads, 16)] * cfg.n_encoder_layers + \
            [(2, S, cfg.n_kv_heads, 16), (2, Te, cfg.n_kv_heads, 16)] * \
            cfg.n_layers
    else:
        want = [(2, S, cfg.n_kv_heads, 16)] * cfg.n_layers
    assert calls["flash_attention"] == want
    assert calls["decode_attention"] == []
    TM.decode_step(tcfg, tparams, _t(tokens[:, :1]).long(), cache, S)
    per_layer = [(2, MAX_LEN, cfg.n_kv_heads, 16)]
    if cfg.is_encoder_decoder:
        per_layer.append((2, Te, cfg.n_kv_heads, 16))
    assert calls["decode_attention"] == per_layer * cfg.n_layers


def test_engines_refuse_both_families():
    """The reference's ``Engine`` prefills ``{"tokens"}`` only: whisper
    fails for want of frames, qwen2-vl for want of M-RoPE positions. The
    port's refuses both at construction, naming why."""
    for arch, err, match in (("whisper-base", KeyError, "frames"),
                             ("qwen2-vl-72b", TypeError, "subscriptable")):
        cfg, params, tcfg, tparams, tok = _setup(arch)
        ref = E.Engine(cfg, params, tok, RUN, max_len=MAX_LEN, chunk=CHUNK)
        with pytest.raises(err, match=match):
            ref.start_session("what is the height of aurora bridge?")
        with pytest.raises(NotImplementedError,
                           match="src/repro/serving/engine.py:54-58"):
            TE.Engine(tcfg, tparams, tok)


def test_serve_launcher_lists_only_servable_archs():
    from repro_torch.launch.serve import servable
    archs = servable()
    assert "whisper-base" not in archs and "qwen2-vl-72b" not in archs
    assert "qwen3-1.7b" in archs and "deepseek-v2-lite-16b" in archs
    assert len(archs) == len(list_configs()) - 2
