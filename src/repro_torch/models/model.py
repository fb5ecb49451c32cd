"""Model assembly for the dense decoder family (llama / qwen / starcoder):
init / prefill / decode, ported from the JAX package's ``models/model.py``.

Conventions
-----------
* Params are a dict: ``{"embed": {"w"}, "final_norm": {"scale"},
  "blocks": [one dict per layer]}`` with the reference's per-layer keys
  and shapes (``models/convert.py`` copies a reference pytree in).
* Prefill runs the naive attention the reference engine runs
  (``RunCfg(attn_impl="naive")``); single-token decode runs the
  ``decode_attention`` kernel on CUDA and its plain version (the
  reference's naive decode math) on CPU.
* The decode cache is ``{"k": (L,B,M,Hkv,Dh), "v": (L,B,M,Hkv,Dh)}``.
  Unlike the reference, which returns a new cache, ``decode_step``
  writes the new token's k/v INTO the cache it is given (no copy of the
  whole cache per step) and returns that same dict.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as Lyr

DECODE_SPLITS = 8      # split-KV chunks per decode_attention launch


def _check_dense(cfg):
    if cfg.family not in ("dense", "vlm") or cfg.use_mla or \
            cfg.rope_kind == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (ROADMAP A9)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(gen, cfg, dtype, device):
    d = cfg.d_model
    return {"ln1": Lyr.rmsnorm_init(d, dtype, device),
            "attn": Lyr.attention_init(gen, cfg, dtype, device),
            "ln2": Lyr.rmsnorm_init(d, dtype, device),
            "mlp": Lyr.mlp_init(gen, cfg, dtype, device)}


def init_model(cfg, generator: torch.Generator, dtype=None, device="cuda"):
    """Random weights from a seeded generator (on ``device``), with the
    reference's shapes and scales; the numbers differ from
    ``jax.random``'s, so parity tests copy reference params instead."""
    _check_dense(cfg)
    dtype = Lyr.torch_dtype(dtype or cfg.dtype)
    vp = cfg.padded_vocab
    params = {
        "embed": {"w": Lyr._normal(generator, (vp, cfg.d_model),
                                   cfg.d_model ** -0.5, dtype, device)},
        "final_norm": Lyr.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Lyr.dense_init(generator, cfg.d_model, vp, dtype,
                                           device)
    params["blocks"] = [init_block(generator, cfg, dtype, device)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _rope_q_k(cfg, p, q, k, positions):
    if cfg.qk_norm:
        q = Lyr.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = Lyr.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_kind == "standard":
        q = Lyr.apply_rope(q, positions, cfg.rope_theta)
        k = Lyr.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def gqa_fullseq(cfg, p, x, positions, *, causal=True):
    """Returns (out (B,S,d), {"k","v"}) for prefill (naive attention)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = Lyr.dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = Lyr.dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = Lyr.dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = _rope_q_k(cfg, p, q, k, positions)
    mask = Lyr.causal_mask(S, S, 0, x.device) if causal else None
    out = Lyr.gqa_scores_softmax_out(q, k, v, mask, hd ** -0.5)
    return Lyr.dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd)), \
        {"k": k, "v": v}


def gqa_decode(cfg, p, x, kc, vc, cache_len: int, lengths, live=None):
    """x (B,1,d); kc/vc (B,M,Hkv,Dh), updated IN PLACE at ``cache_len``
    (rows where ``live`` is False keep their old entry — the reference's
    masked dead-slot writes, engine.py:60-82). Returns out (B,1,d)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q = Lyr.dense(p["wq"], x).reshape(B, 1, Hq, hd)
    k = Lyr.dense(p["wk"], x).reshape(B, 1, Hkv, hd)
    v = Lyr.dense(p["wv"], x).reshape(B, 1, Hkv, hd)
    q, k = _rope_q_k(cfg, p, q, k, positions)
    # a write past the end lands on the last slot, as the reference's
    # clamping dynamic_update_slice does
    pos = min(cache_len, kc.shape[1] - 1)
    for c, new in ((kc, k), (vc, v)):
        new = new[:, 0].to(c.dtype)
        if live is not None:
            new = torch.where(live[:, None, None], new, c[:, pos])
        c[:, pos] = new
    out = ops.decode_attention(q[:, 0], kc, vc, lengths, DECODE_SPLITS)
    # the reference's P.V einsum yields the cache dtype (bf16 for the
    # batched cache) before the f32 output projection
    out = out.to(kc.dtype).to(x.dtype)
    return Lyr.dense(p["wo"], out.reshape(B, 1, Hq * hd))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_fullseq(cfg, p, x, positions):
    """One dense layer over a full sequence. Returns (x, kv)."""
    h, kv = gqa_fullseq(cfg, p["attn"], Lyr.rmsnorm(p["ln1"], x,
                                                    cfg.norm_eps), positions)
    x = x + h
    x = x + Lyr.mlp(cfg, p["mlp"], Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, kv


def block_decode(cfg, p, x, kc, vc, cache_len: int, lengths, live=None):
    """One dense layer, one token; kc/vc are this layer's cache slices."""
    h = gqa_decode(cfg, p["attn"], Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps),
                   kc, vc, cache_len, lengths, live)
    x = x + h
    return x + Lyr.mlp(cfg, p["mlp"], Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    return params["embed"]["w"][tokens]


def lm_logits(cfg, params, x):
    x = Lyr.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["w"].T
    else:
        logits = Lyr.dense(params["lm_head"], x)
    if cfg.padded_vocab != cfg.vocab_size:   # mask Megatron vocab padding
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Prefill / cache / decode
# ---------------------------------------------------------------------------


def prefill(cfg, params, tokens, max_len: Optional[int] = None):
    """tokens (B,S) -> (logits of the last position (B,1,V), cache with
    seq dims zero-padded to ``max_len``) in the params' dtype."""
    _check_dense(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed_tokens(cfg, params, tokens)
    ks, vs = [], []
    for lp in params["blocks"]:
        x, kv = block_fullseq(cfg, lp, x, positions)
        ks.append(kv["k"])
        vs.append(kv["v"])
    pad = (0, 0, 0, 0, 0, max(max_len - S, 0))
    cache = {"k": torch.nn.functional.pad(torch.stack(ks), pad),
             "v": torch.nn.functional.pad(torch.stack(vs), pad)}
    return lm_logits(cfg, params, x[:, -1:]), cache


def cache_struct(cfg, batch, max_len, dtype=None):
    """{name: (shape, dtype)} of the decode cache."""
    _check_dense(cfg)
    dt = Lyr.torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": (shape, dt), "v": (shape, dt)}


def init_cache(cfg, batch, max_len, dtype=None, device="cuda"):
    return {n: torch.zeros(s, dtype=d, device=device)
            for n, (s, d) in cache_struct(cfg, batch, max_len, dtype).items()}


def decode_step(cfg, params, token, cache, cache_len: int, live=None):
    """token (B,1) int; cache per ``cache_struct`` (updated in place);
    cache_len: the position this token is written at (it attends
    [0, cache_len]). ``live`` (B,) bool masks the cache writes of dead
    slots. Returns (logits (B,1,V), cache)."""
    B = token.shape[0]
    x = embed_tokens(cfg, params, token)
    lengths = torch.full((B,), cache_len, dtype=torch.int32,
                         device=token.device)
    for i, lp in enumerate(params["blocks"]):
        x = block_decode(cfg, lp, x, cache["k"][i], cache["v"][i], cache_len,
                         lengths, live)
    return lm_logits(cfg, params, x), cache
