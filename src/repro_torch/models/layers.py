"""Core layer primitives in PyTorch: init helpers, norms (and Mamba2's
gated norm), MLPs, RoPE, M-RoPE and sinusoidal positions, attention and
cross-attention params, and the reference's plain attention math
(``gqa_scores_softmax_out`` and ``causal_mask``, which live beside the
kernels' oracles in ``kernels/ref.py``, ``attention``,
``cross_attention``) — the JAX package's ``models/layers.py`` as plain
functions over dicts of tensors. The model runs its attention through
``models/model.py`` (the kernels on a card); these are the plain math
that the kernels' CPU versions and the model's ``"naive"`` path share.

Weights keep the reference's layout (``dense`` weights are ``(d_in,
d_out)``), so ``models/convert.py`` copies a reference pytree without
transposes. Shapes use B=batch, S=query length, T=key length, H=heads,
K=kv heads, D=head dim.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# the plain attention math, shared with B4's plain version
from repro_torch.kernels.ref import causal_mask, gqa_scores_softmax_out


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# Init helpers (seeded torch.Generator, the reference's shapes and scales)
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, dtype, device):
    # scaled in place: a full-width model is initialised on the card
    # tensor by tensor, with no second f32 copy of the largest one
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, bias=False, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def gated_rmsnorm(p, x, z, eps=1e-6, groups=1):
    """Mamba2-style gated norm: rmsnorm(x * silu(z)), each of ``groups``
    equal parts of the last dim normed on its own (Mamba-2's norm over
    its SSM groups); one group is the whole width."""
    if groups == 1:
        return rmsnorm(p, x * F.silu(z), eps)
    g = (x * F.silu(z)).unflatten(-1, (groups, -1))
    var = g.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (g * inv).flatten(-2) * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg, dtype, device, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w1": dense_init(gen, d, ff, dtype, device),
         "w2": dense_init(gen, ff, d, dtype, device)}
    if cfg.gated_mlp:
        p["w3"] = dense_init(gen, d, ff, dtype, device)
    return p


def activation(cfg, h):
    """The MLP's activation: SiLU, relu² (``"relu2"``), else GELU."""
    if cfg.mlp_act == "silu":
        return F.silu(h)
    if cfg.mlp_act == "relu2":
        return torch.square(F.relu(h))
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h, approximate="tanh")


def mlp(cfg, p, x):
    h = activation(cfg, dense(p["w1"], x))
    if cfg.gated_mlp:
        h = h * dense(p["w3"], x)
    return dense(p["w2"], h)


# ---------------------------------------------------------------------------
# Positions: RoPE and M-RoPE (decoder), sinusoidal (the MiniLM encoder,
# whisper's encoder and decoder)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim, theta, device: torch.device) -> torch.Tensor:
    # one host->device copy per (head_dim, theta, device): a copy from
    # pageable host memory on every call would stall the launch queue
    # twice per layer and decode step
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def sinusoidal_positions(seq_len, d_model) -> torch.Tensor:
    """(seq_len, d_model) f32 sin/cos table, computed in numpy float64 and
    cast once, so it is bitwise the reference's."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / (10000 ** (dim / d_model))
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S) int."""
    D = x.shape[-1]
    inv = _inv_freq(D, theta, x.device)                           # (D/2,)
    angles = positions[..., None].float() * inv                  # (B,S,D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta, sections):
    """M-RoPE (Qwen2-VL): x (B, S, H, D); positions (3, B, S) int for the
    t/h/w streams; ``sections`` partitions the D/2 frequency slots among
    the three streams in that order (the reference picks each slot's
    stream with a one-hot product, which selects exactly)."""
    D = x.shape[-1]
    inv = _inv_freq(D, theta, x.device)                           # (D/2,)
    angles = positions[..., None].float() * inv                  # (3,B,S,D/2)
    bounds = np.cumsum((0,) + tuple(sections))
    angles = torch.cat([angles[i, ..., bounds[i]:bounds[i + 1]]
                        for i in range(3)], dim=-1)              # (B,S,D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: params, projections and the reference's plain math (the
# model's attention runs the kernels in repro_torch.kernels on a card)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device,
                          bias=cfg.attn_bias),
         "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                          bias=cfg.attn_bias),
         "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                          bias=cfg.attn_bias),
         "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def cross_attention_init(gen, cfg, dtype, device):
    """The encoder-decoder's cross-attention params: ``attention_init``'s
    layout (queries from the decoder, keys and values from the encoder;
    no RoPE, no mask)."""
    return attention_init(gen, cfg, dtype, device)


def rope_q_k(cfg, p, q, k, positions, mrope_positions=None):
    """qk-norm (when the config has it), then RoPE or M-RoPE on q and k
    (B, S, H, D)."""
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_kind == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        if mrope_positions is None:
            raise ValueError(f"{cfg.name}: M-RoPE needs mrope_positions "
                             "(3, B, S)")
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    return q, k


def qkv(cfg, p, x, positions, mrope_positions=None):
    """The self-attention's q (B,S,Hq,D), k and v (B,S,Hkv,D) of ``x``,
    q and k normed and roped."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = rope_q_k(cfg, p, q, k, positions, mrope_positions)
    return q, k, v


def cross_qkv(cfg, p, x, enc_out):
    """The cross-attention's q (B,S,Hq,D) from the decoder and k, v
    (B,Te,Hkv,D) from the encoder output (no RoPE)."""
    B, S, _ = x.shape
    Te = enc_out.shape[1]
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], enc_out).reshape(B, Te, cfg.n_kv_heads, hd)
    v = dense(p["wv"], enc_out).reshape(B, Te, cfg.n_kv_heads, hd)
    return q, k, v


def attention(cfg, p, x, positions, *, mask_offset=0, kv_cache=None,
              cache_len=None, mrope_positions=None):
    """The reference's plain attention. With ``kv_cache`` None (prefill,
    training): causal over ``x``'s own tokens at ``mask_offset``; returns
    (out, {"k", "v"} of these tokens). With ``kv_cache`` ({"k", "v"}
    (B,M,Hkv,D)): decode, the new entries written at ``cache_len``
    (clamped to the last slot, as ``dynamic_update_slice`` clamps) in
    place, attending [0, cache_len]; returns (out, the cache). The
    reference's decode branch raises (its mask has a rank too many); this
    one computes what ``models/model.py:gqa_decode`` computes."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = qkv(cfg, p, x, positions, mrope_positions)
    if kv_cache is None:
        out = gqa_scores_softmax_out(
            q, k, v, causal_mask(S, S, mask_offset, x.device), hd ** -0.5)
        new_kv = {"k": k, "v": v}
    else:
        kc, vc = kv_cache["k"], kv_cache["v"]
        T = kc.shape[1]
        pos = min(int(cache_len), T - S)
        kc[:, pos:pos + S] = k.to(kc.dtype)
        vc[:, pos:pos + S] = v.to(vc.dtype)
        mask = (torch.arange(T, device=x.device) <= int(cache_len))
        out = gqa_scores_softmax_out(q, kc, vc, mask, hd ** -0.5)
        new_kv = kv_cache
    return dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd)), new_kv


def cross_attention(cfg, p, x, enc_out):
    """Decoder cross-attention over the encoder output (no mask, no
    RoPE)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = cross_qkv(cfg, p, x, enc_out)
    out = gqa_scores_softmax_out(q, k, v, None, hd ** -0.5)
    return dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
