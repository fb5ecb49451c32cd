"""Plain PyTorch MiniLM-class query encoder: the reference the benchmark
holds the port's embedder to.

Layers of the configuration's width and heads (MiniLM: six of 384 wide,
six heads of 64, a 1536-wide GELU (tanh) MLP), pre-RMS norms (eps 1e-5
in the layers, 1e-6 at the end), sinusoidal positions added to the token embeddings, every one of the 64
positions attending to every other (padding included: the mask weights
only the mean pooling), then L2 normalisation. The weights are the dict
the benchmark made (``{"embed": {"w"}, "blocks": [...], "final_norm":
{"scale"}}``); nothing here comes from the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_LEN = 64
EPS_LAYER, EPS_FINAL = 1e-5, 1e-6


def sinusoid(seq_len: int, dim: int) -> torch.Tensor:
    pos = np.arange(seq_len)[:, None]
    ang = pos / (10000 ** (np.arange(0, dim, 2)[None, :] / dim))
    out = np.zeros((seq_len, dim), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def token_batch(tok, texts, device):
    """(ids (B, 64), mask (B, 64)): each text's ids cut to 64, zero-padded."""
    ids = np.zeros((len(texts), MAX_LEN), np.int64)
    mask = np.zeros((len(texts), MAX_LEN), np.float32)
    for i, t in enumerate(texts):
        e = tok.encode(t)[:MAX_LEN]
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1.0
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device))


@torch.no_grad()
def encode(params, tok, texts, heads: int, block: int = 256) -> torch.Tensor:
    """(len(texts), width) f32 unit rows, ``block`` texts at a time."""
    dev = params["embed"]["w"].device
    outs = []
    for lo in range(0, len(texts), block):
        ids, mask = token_batch(tok, texts[lo:lo + block], dev)
        outs.append(_forward(params, ids, mask, heads))
    return torch.cat(outs)


def _forward(params, ids, mask, heads):
    emb = params["embed"]["w"]
    B, L = ids.shape
    d = emb.shape[1]
    hd = d // heads
    x = emb[ids] + sinusoid(L, d).to(emb.device, emb.dtype)[None]
    mask = mask.to(emb.dtype)
    for p in params["blocks"]:
        h = rms(x, p["ln1"]["scale"], EPS_LAYER)
        a = p["attn"]
        q, k, v = (
            (h @ a[n]["w"]).reshape(B, L, heads, hd).transpose(1, 2)
            for n in ("wq", "wk", "wv"))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, d)
        x = x + o @ a["wo"]["w"]
        h = rms(x, p["ln2"]["scale"], EPS_LAYER)
        m = p["mlp"]
        x = x + F.gelu(h @ m["w1"]["w"], approximate="tanh") @ m["w2"]["w"]
    x = rms(x, params["final_norm"]["scale"], EPS_FINAL)
    pooled = (x * mask[..., None]).sum(1) / mask.sum(1, keepdim=True) \
        .clamp(min=1.0)
    return (pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)) \
        .float()
