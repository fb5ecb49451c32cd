"""Core layer primitives in PyTorch: init helpers, norms, MLPs, RoPE, GQA
attention — the dense-family subset of the JAX package's
``models/layers.py``, as plain functions over dicts of tensors.

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


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# Init helpers (seeded torch.Generator, the reference's shapes and scales)
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


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


def mlp(cfg, p, x):
    h = dense(p["w1"], x)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.silu(h) if cfg.mlp_act == "silu" else F.gelu(h, approximate="tanh")
    if cfg.gated_mlp:
        h = h * dense(p["w3"], x)
    return dense(p["w2"], h)


# ---------------------------------------------------------------------------
# RoPE
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


# ---------------------------------------------------------------------------
# Attention (naive GQA path; the decode kernel lives in repro_torch.kernels)
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


def gqa_scores_softmax_out(q, k, v, mask, scale):
    """q: (B,S,Hq,D) k,v: (B,T,Hkv,D[v]), mask: broadcastable (B,1,1,S,T) or
    None. Returns (B,S,Hq,Dv). Softmax in f32; probabilities cast to v's
    dtype before P.V, as in the reference."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(q.dtype)).float()
    logits = logits * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkv->bskgv", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, v.shape[-1])


def causal_mask(S, T, offset, device):
    """Query i (global pos offset+i) may attend key j iff j <= offset + i."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= (i + offset))[None, None, None, :, :]
