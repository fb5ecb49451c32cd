"""Model assembly: init / prefill / decode for the dense (llama / qwen /
starcoder), moe (deepseek: MLA + MoE; grok: GQA + MoE), ssm (mamba2) and
hybrid (zamba2: Mamba2 backbone + one weight-shared attention block)
families, ported from the JAX package's ``models/model.py``. The encdec
(whisper) and vlm (M-RoPE) families are not ported yet.

Conventions
-----------
* Params are a dict: ``{"embed": {"w"}, "final_norm": {"scale"},
  "blocks": [one dict per layer]}`` with the reference's per-layer keys
  and shapes, plus ``"dense0"`` (deepseek's leading dense layers, a list
  like ``"blocks"``) and ``"shared"`` (zamba2's one shared block, a single
  layer's dict). ``models/convert.py`` copies a reference pytree in.
* Full-sequence attention (prefill, causal; the MiniLM encoder's
  ``kind="enc"`` layers, non-causal; MLA's expanded heads) runs the
  ``flash_attention`` kernel on CUDA, single-token GQA decode the
  ``decode_attention`` kernel. On CPU both wrappers take their plain
  versions, which are the naive attention the reference engine and
  encoder run (``RunCfg(attn_impl="naive")``). ``attn_impl="naive"`` (the
  counterpart of the reference's ``RunCfg.attn_impl``) runs the
  full-sequence attention as that plain math on any device, under
  autograd: the kernel has no backward, so training
  (``MiniLMEncoder.train_contrastive``) asks for it. MLA's absorbed
  decode (one latent head of 576/512 over the compressed cache) and the
  MoE expert products are plain PyTorch, as they are plain einsums in the
  reference.
* Decode caches, leading dim = layer (or shared-block invocation):
    GQA    : {"k": (L,B,M,Hkv,Dh), "v": (L,B,M,Hkv,Dh)}
    MLA    : {"ckv": (L,B,M,r), "krope": (L,B,M,dr)}
    SSM    : {"h": (L,B,H,P,N) f32, "conv": (L,B,W-1,C)}
    hybrid : SSM + {"ak"/"av": (I,B,M,Hkv,Dh)}, I = shared invocations
  Unlike the reference, which returns a new cache, ``decode_step`` writes
  INTO the cache it is given (no copy of the whole cache per step) and
  returns that same dict. Under ``live`` a dead slot computes its step as
  the reference's does (its new attention entry is written, attended and
  then put back; its SSM state is read and not written), so its rows of
  every leaf end the step as they began it: the reference's masked
  dead-slot writes (``serving/engine.py:60-82``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as Lyr
from repro_torch.models import mla as Mla
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm

DECODE_SPLITS = 8      # split-KV chunks per decode_attention launch


def _check_ported(cfg):
    if cfg.family in ("encdec", "vlm") or cfg.is_encoder_decoder or \
            cfg.rope_kind == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: the encdec and vlm families and M-RoPE are not "
            "ported (ROADMAP A9)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(gen, cfg, dtype, device, kind="dense"):
    """One layer's params: ``"dense"`` (decoder; MLA attention when the
    config has it), ``"enc"`` (the non-causal encoder layer), ``"moe"``,
    ``"moe_dense0"`` (deepseek's leading dense layer, ``d_ff_dense``
    wide) or ``"ssm"``."""
    d = cfg.d_model
    if kind == "ssm":
        return {"ln": Lyr.rmsnorm_init(d, dtype, device),
                "ssm": Ssm.ssm_init(gen, cfg, dtype, device)}
    if kind not in ("dense", "enc", "moe", "moe_dense0"):
        raise ValueError(f"block kind {kind!r}")
    attn = Mla.mla_init(gen, cfg, dtype, device) \
        if cfg.use_mla and kind != "enc" else \
        Lyr.attention_init(gen, cfg, dtype, device)
    p = {"ln1": Lyr.rmsnorm_init(d, dtype, device), "attn": attn,
         "ln2": Lyr.rmsnorm_init(d, dtype, device)}
    if kind == "moe":
        p["moe"] = Moe.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = (cfg.d_ff_dense or cfg.d_ff) if kind == "moe_dense0" else None
        p["mlp"] = Lyr.mlp_init(gen, cfg, dtype, device, d_ff=d_ff)
    return p


def main_block_kind(cfg) -> str:
    return {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
            "hybrid": "ssm"}[cfg.family]


def n_shared_attn(cfg) -> int:
    """# shared-attention invocations in a hybrid stack (layers i%k==0)."""
    k = cfg.hybrid_attn_every
    return -(-cfg.n_layers // k) if k else 0


def init_model(cfg, generator: torch.Generator, dtype=None, device="cuda"):
    """Random weights from a seeded generator (on ``device``), with the
    reference's shapes and scales; the numbers differ from
    ``jax.random``'s, so parity tests copy reference params instead."""
    _check_ported(cfg)
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
    n_dense0 = _n_dense0(cfg)
    kind = main_block_kind(cfg)
    params["blocks"] = [init_block(generator, cfg, dtype, device, kind)
                        for _ in range(cfg.n_layers - n_dense0)]
    if n_dense0:
        params["dense0"] = [init_block(generator, cfg, dtype, device,
                                       "moe_dense0")
                            for _ in range(n_dense0)]
    if cfg.family == "hybrid":
        params["shared"] = init_block(generator, cfg, dtype, device, "dense")
    return params


def _n_dense0(cfg) -> int:
    return cfg.first_dense_layers if cfg.family == "moe" else 0


def _layers(cfg, params):
    """(kind, params) of every layer of a uniform stack, in order:
    deepseek's ``dense0`` layers first, then ``blocks``."""
    kind = main_block_kind(cfg)
    return [("moe_dense0", p) for p in params.get("dense0", [])] + \
        [(kind, p) for p in params["blocks"]]


# ---------------------------------------------------------------------------
# Attention (full sequence)
# ---------------------------------------------------------------------------


def _rope_q_k(cfg, p, q, k, positions):
    if cfg.qk_norm:
        q = Lyr.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = Lyr.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_kind == "standard":
        q = Lyr.apply_rope(q, positions, cfg.rope_theta)
        k = Lyr.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _attend(q, k, v, causal, attn_impl):
    if attn_impl == "kernel":
        return ops.flash_attention(q, k, v, causal)
    if attn_impl == "naive":
        return flash_attention_plain(q, k, v, causal)
    raise ValueError(f"attn_impl must be 'kernel' or 'naive', got "
                     f"{attn_impl!r}")


def gqa_fullseq(cfg, p, x, positions, *, causal=True, attn_impl="kernel"):
    """Returns (out (B,S,d), {"k","v"}) for prefill and the encoder.
    ``attn_impl``: ``"kernel"`` (B4 on CUDA, its plain version on the
    CPU) or ``"naive"`` (the plain math on any device, differentiable)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = Lyr.dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = Lyr.dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = Lyr.dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = _rope_q_k(cfg, p, q, k, positions)
    out = _attend(q, k, v, causal, attn_impl)
    return Lyr.dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd)), \
        {"k": k, "v": v}


def mla_fullseq(cfg, p, x, positions, *, attn_impl="kernel"):
    """MLA prefill: the compressed KV expanded per head, causal attention
    with q/k of nope + rope and v of ``v_head_dim`` (B4 zero-pads v to the
    q/k width, which is exact). Returns (out, {"ckv","krope"}): the cache
    stays compressed."""
    B, S, _ = x.shape
    H, rd = cfg.n_heads, cfg.qk_rope_head_dim
    qn, qr = Mla._project_q(cfg, p, x)
    qr = Lyr.apply_rope(qr, positions, cfg.rope_theta)
    ckv, krope = Mla._project_ckv(cfg, p, x, positions)
    kn = torch.einsum("bsr,rhn->bshn", ckv, p["wuk"])
    v = torch.einsum("bsr,rhv->bshv", ckv, p["wuv"])
    q = torch.cat([qn, qr], dim=-1)                       # (B,S,H,nope+rd)
    k = torch.cat([kn, krope.expand(B, S, H, rd)], dim=-1)
    out = _attend(q, k, v, True, attn_impl)
    return Lyr.dense(p["wo"], out.reshape(B, S, H * cfg.v_head_dim)), \
        {"ckv": ckv, "krope": krope[:, :, 0, :]}


# ---------------------------------------------------------------------------
# Attention (single-token decode)
# ---------------------------------------------------------------------------


def _write(c, pos: int, new, live):
    """Write ``new`` (B, ...) at position ``pos`` of the cache slice ``c``
    (B, M, ...) in place; returns what a dead slot must get back (None
    when every slot is live)."""
    old = None if live is None else c[:, pos].clone()
    c[:, pos] = new.to(c.dtype)
    return old


def _restore(c, pos: int, old, live):
    """Put a dead slot's entry at ``pos`` back after its step attended it."""
    if live is not None:
        keep = live.view((-1,) + (1,) * (old.dim() - 1))
        c[:, pos] = torch.where(keep, c[:, pos], old)


def _decode_pos(cache_len: int, c) -> int:
    # a write past the end lands on the last slot, as the reference's
    # clamping dynamic_update_slice does
    return min(cache_len, c.shape[1] - 1)


def gqa_decode(cfg, p, x, kc, vc, cache_len: int, lengths, live=None):
    """x (B,1,d); kc/vc (B,M,Hkv,Dh), written in place at ``cache_len``
    (put back afterwards for the rows where ``live`` is False). Returns
    out (B,1,d)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q = Lyr.dense(p["wq"], x).reshape(B, 1, Hq, hd)
    k = Lyr.dense(p["wk"], x).reshape(B, 1, Hkv, hd)
    v = Lyr.dense(p["wv"], x).reshape(B, 1, Hkv, hd)
    q, k = _rope_q_k(cfg, p, q, k, positions)
    pos = _decode_pos(cache_len, kc)
    olds = [_write(c, pos, new[:, 0], live) for c, new in ((kc, k), (vc, v))]
    out = ops.decode_attention(q[:, 0], kc, vc, lengths, DECODE_SPLITS)
    for c, old in zip((kc, vc), olds):
        _restore(c, pos, old, live)
    # the reference's P.V einsum yields the cache dtype (bf16 for the
    # batched cache) before the f32 output projection
    out = out.to(kc.dtype).to(x.dtype)
    return Lyr.dense(p["wo"], out.reshape(B, 1, Hq * hd))


def mla_decode(cfg, p, x, ckv_c, krope_c, cache_len: int, live=None):
    """Absorbed decode over the compressed cache ckv_c (B,M,r) and krope_c
    (B,M,dr), written in place at ``cache_len`` as ``gqa_decode`` writes.
    The products follow the reference's dtypes: a bf16 cache is widened
    exactly against the f32 query, the probabilities and P.V are rounded
    to the cache dtype."""
    B = x.shape[0]
    H = cfg.n_heads
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    qn, qr = Mla._project_q(cfg, p, x)
    qr = Lyr.apply_rope(qr, positions, cfg.rope_theta)
    ckv_new, krope_new = Mla._project_ckv(cfg, p, x, positions)
    q_c = torch.einsum("bshn,rhn->bshr", qn, p["wuk"])
    pos = _decode_pos(cache_len, ckv_c)
    olds = [_write(ckv_c, pos, ckv_new[:, 0], live),
            _write(krope_c, pos, krope_new[:, 0, 0], live)]
    ckv, krope = ckv_c.to(q_c.dtype), krope_c.to(q_c.dtype)
    T = ckv_c.shape[1]
    logits = (torch.einsum("bshr,btr->bhst", q_c, ckv)
              + torch.einsum("bshr,btr->bhst", qr, krope)).float()
    mask = torch.arange(T, device=x.device) <= cache_len
    logits = (logits * scale).masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(ckv_c.dtype)
    out_c = torch.einsum("bhst,btr->bshr", probs.float(),
                         ckv_c.float()).to(ckv_c.dtype)
    for c, old in zip((ckv_c, krope_c), olds):
        _restore(c, pos, old, live)
    out = torch.einsum("bshr,rhv->bshv", out_c.to(x.dtype), p["wuv"])
    return Lyr.dense(p["wo"], out.reshape(B, 1, H * cfg.v_head_dim))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ffn(cfg, p, x, kind):
    h = Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        return Moe.moe_ffn(cfg, p["moe"], h)
    return Lyr.mlp(cfg, p["mlp"], h)


def block_fullseq(cfg, p, x, positions, kind="dense", attn_impl="kernel"):
    """One layer over a full sequence: ``"dense"``/``"moe"``/
    ``"moe_dense0"`` attend causally, ``"enc"`` to every position,
    ``"ssm"`` runs the SSD scan. Returns (x, this layer's cache entries).
    ``attn_impl`` as in ``gqa_fullseq``."""
    if kind == "ssm":
        h, (hs, conv) = Ssm.ssm_forward(
            cfg, p["ssm"], Lyr.rmsnorm(p["ln"], x, cfg.norm_eps))
        return x + h, {"h": hs, "conv": conv}
    if kind not in ("dense", "enc", "moe", "moe_dense0"):
        raise ValueError(f"block kind {kind!r}")
    xin = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla and kind != "enc":
        h, kv = mla_fullseq(cfg, p["attn"], xin, positions,
                            attn_impl=attn_impl)
    else:
        h, kv = gqa_fullseq(cfg, p["attn"], xin, positions,
                            causal=(kind != "enc"), attn_impl=attn_impl)
    x = x + h
    return x + _ffn(cfg, p, x, kind), kv


def block_decode(cfg, p, x, csl, cache_len: int, lengths, live=None,
                 kind="dense"):
    """One layer, one token; ``csl`` is this layer's cache slice (its
    leaves without the layer dim), updated in place."""
    if kind == "ssm":
        h, (hs, conv) = Ssm.ssm_decode(
            cfg, p["ssm"], Lyr.rmsnorm(p["ln"], x, cfg.norm_eps), csl["h"],
            csl["conv"])
        for name, new in (("h", hs), ("conv", conv)):
            c = csl[name]
            if live is not None:
                new = torch.where(live.view((-1,) + (1,) * (c.dim() - 1)),
                                  new, c)
            c.copy_(new)
        return x + h
    xin = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        h = mla_decode(cfg, p["attn"], xin, csl["ckv"], csl["krope"],
                       cache_len, live)
    else:
        h = gqa_decode(cfg, p["attn"], xin, csl["k"], csl["v"], cache_len,
                       lengths, live)
    x = x + h
    return x + _ffn(cfg, p, x, kind)


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


def _stack(entries):
    """[{name: (B, ...)}] per layer -> {name: (L, B, ...)}."""
    return {n: torch.stack([e[n] for e in entries]) for n in entries[0]}


def _pad_seq(t, max_len: int):
    """(L, B, S, ...) zero-padded to (L, B, max_len, ...)."""
    S = t.shape[2]
    if max_len <= S:
        return t
    out = t.new_zeros(tuple(t.shape[:2]) + (max_len,) + tuple(t.shape[3:]))
    out[:, :, :S] = t
    return out


def prefill(cfg, params, tokens, max_len: Optional[int] = None):
    """tokens (B,S) -> (logits of the last position (B,1,V), cache with
    seq dims zero-padded to ``max_len``) in the params' dtype (``h`` f32)."""
    _check_ported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "hybrid":
        k_every = cfg.hybrid_attn_every
        states, attn = [], []
        for i, lp in enumerate(params["blocks"]):
            if k_every and i % k_every == 0:
                x, kv = block_fullseq(cfg, params["shared"], x, positions)
                attn.append(kv)
            x, st = block_fullseq(cfg, lp, x, positions, kind="ssm")
            states.append(st)
        cache = _stack(states)
        akv = _stack(attn)
        cache["ak"] = _pad_seq(akv["k"], max_len)
        cache["av"] = _pad_seq(akv["v"], max_len)
    else:
        entries = []
        for kind, lp in _layers(cfg, params):
            x, kv = block_fullseq(cfg, lp, x, positions, kind=kind)
            entries.append(kv)
        cache = _stack(entries)
        if cfg.family != "ssm":
            cache = {n: _pad_seq(t, max_len) for n, t in cache.items()}
    return lm_logits(cfg, params, x[:, -1:]), cache


def cache_struct(cfg, batch, max_len, dtype=None):
    """{name: (shape, dtype)} of the decode cache (``h`` always f32)."""
    _check_ported(cfg)
    dt = Lyr.torch_dtype(dtype or cfg.dtype)
    L, B, M = cfg.n_layers, batch, max_len
    if cfg.use_mla:
        return {"ckv": ((L, B, M, cfg.kv_lora_rank), dt),
                "krope": ((L, B, M, cfg.qk_rope_head_dim), dt)}
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family in ("dense", "moe"):
        return {"k": ((L, B, M) + kv, dt), "v": ((L, B, M) + kv, dt)}
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    C = cfg.d_inner_ssm + 2 * cfg.ssm_n_groups * N
    out = {"h": ((L, B, H, P, N), torch.float32),
           "conv": ((L, B, cfg.ssm_conv - 1, C), dt)}
    if cfg.family == "hybrid":
        I = n_shared_attn(cfg)
        out["ak"] = ((I, B, M) + kv, dt)
        out["av"] = ((I, B, M) + kv, dt)
    return out


def init_cache(cfg, batch, max_len, dtype=None, device="cuda"):
    return {n: torch.zeros(s, dtype=d, device=device)
            for n, (s, d) in cache_struct(cfg, batch, max_len, dtype).items()}


def decode_step(cfg, params, token, cache, cache_len: int, live=None):
    """token (B,1) int; cache per ``cache_struct`` (updated in place);
    cache_len: the position this token is written at (it attends
    [0, cache_len]). ``live`` (B,) bool keeps the cache rows of dead
    slots as they were. Returns (logits (B,1,V), cache)."""
    B = token.shape[0]
    x = embed_tokens(cfg, params, token)
    lengths = torch.full((B,), cache_len, dtype=torch.int32,
                         device=token.device)
    if cfg.family == "hybrid":
        k_every, inv = cfg.hybrid_attn_every, 0
        for i, lp in enumerate(params["blocks"]):
            if k_every and i % k_every == 0:
                x = block_decode(cfg, params["shared"], x,
                                 {"k": cache["ak"][inv],
                                  "v": cache["av"][inv]},
                                 cache_len, lengths, live)
                inv += 1
            x = block_decode(cfg, lp, x, {"h": cache["h"][i],
                                          "conv": cache["conv"][i]},
                             cache_len, lengths, live, kind="ssm")
    else:
        for i, (kind, lp) in enumerate(_layers(cfg, params)):
            x = block_decode(cfg, lp, x, {n: t[i] for n, t in cache.items()},
                             cache_len, lengths, live, kind=kind)
    return lm_logits(cfg, params, x), cache
