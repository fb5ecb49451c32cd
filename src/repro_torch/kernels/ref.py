"""Oracles for every kernel of the port: the numpy bit-for-bit targets of
the MIPS top-k pair (copied from the JAX package's ``kernels/ref.py``),
torch versions of the attention and fp32 MIPS oracles, and the plain
grouped-query attention math (``gqa_scores_softmax_out``, ``causal_mask``)
that the models' naive attention runs and B4 is held against."""
from __future__ import annotations

import numpy as np
import torch


def topk_by_value_ref(s, k):
    """Numpy top-k along the last axis ordered by (value desc, index asc) —
    the exact tie-break contract of both MIPS kernels."""
    s = np.asarray(s)
    order = np.argsort(-s, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(s, order, axis=-1), order.astype(np.int32)


def mips_topk_int8_ref(q, q_scale, x, x_scale, k):
    """Bit-for-bit reference for the int8 kernel: exact int32 accumulation,
    then the SAME f32 dequant multiply order the kernel uses
    (acc -> f32, * q_scale, * x_scale) and the same tie-break."""
    q = np.asarray(q, np.int32)
    x = np.asarray(x, np.int32)
    s = (q @ x.T).astype(np.float32)
    s = s * np.asarray(q_scale, np.float32)[:, None]
    s = s * np.asarray(x_scale, np.float32)[None, :]
    return topk_by_value_ref(s, k)


def topk_by_value(s: torch.Tensor, k: int):
    """Torch top-k along the last axis in (value desc, index asc) order.
    ``torch.topk`` promises no order among equal values, so ties go through
    a stable descending sort (k = 1 is a first-occurrence argmax)."""
    if k == 1:
        i = torch.argmax(s, dim=-1, keepdim=True)
        return torch.gather(s, -1, i), i.to(torch.int32)
    v, i = torch.sort(s, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


def mips_topk_ref(q, x, k):
    """q: (Q,D); x: (N,D) -> (vals (Q,k), idx (Q,k)) exact MIPS top-k."""
    return topk_by_value(q.float() @ x.float().T, k)


def decode_attention_ref(q, k, v, lengths):
    """q: (B,Hq,D); k,v: (B,T,Hkv,D); attend [0, lengths[b]] inclusive."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (D ** -0.5)
    mask = torch.arange(T, device=q.device)[None, :] <= lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, Hq, D)


def attention_ref(q, k, v, *, causal=True):
    """Head-major GQA attention oracle. q: (B,Hq,S,D); k,v: (B,Hkv,T,D)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k).float() * (D ** -0.5)
    if causal:
        mask = torch.arange(T, device=q.device)[None, :] <= \
            torch.arange(S, device=q.device)[:, None]
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype), v)
    return o.reshape(B, Hq, S, D)


def gqa_scores_softmax_out(q, k, v, mask, scale):
    """q (B,S,Hq,D), k and v (B,T,Hkv,D[v]); ``mask`` a bool broadcastable
    to (B,Hkv,G,S,T) (``causal_mask``'s (1,1,1,S,T)) or None. Returns
    (B,S,Hq,Dv) in v's dtype: scores and softmax in f32, the
    probabilities cast to v's dtype before P.V, as in the reference."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(q.dtype)).float() * scale
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkv->bskgv", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, v.shape[-1])


def causal_mask(S, T, offset, device=None):
    """Query i (global position ``offset + i``) may attend key j iff
    j <= offset + i: a (1,1,1,S,T) bool."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= i + offset)[None, None, None]
