"""B3 ``decode_attention``: split-KV flash decoding (one new token per row,
grouped-query attention).

The CUDA kernel (``csrc/decode_attention.cu``) replaces the JAX package's
``kernels/decode_attention.py:decode_attention_pallas`` together with its
``combine_splits``: one launch computes the per-split partials (o, m, l)
and their max-rescale merge, and returns what ``ops.decode_attention``
returns, (B, Hq, D) f32.

Two plain versions sit beside it:

* ``decode_attention_plain`` — the naive decode math the reference engine
  runs (``models/model.py:gqa_decode``): f32 scores, inclusive mask, f32
  softmax, probabilities rounded to the cache dtype before P.V. It is the
  CPU path of ``ops.decode_attention``, so greedy tokens can match the
  reference engine on CPU.
* ``combine_splits(*decode_partials_plain(...))`` — the kernel's own split
  arithmetic in torch (the counterpart of the Pallas ``_decode_kernel``
  and ``combine_splits``): what the kernel is held against, and what shows
  ``n_splits`` invariance on CPU.

With a bf16 cache the two differ by bf16 rounding of p: the naive math
rounds the normalised probability, the split math the unnormalised
``exp(s - m_split)``, so each P.V term may differ by one bf16 ulp of p
(2^-8 relative); with f32 caches they agree to summation order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import aligned16

NEG = -1e30
MAX_HEAD_DIM = 256

ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_void_p] * 2)
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


def decode_attention_plain(q, k, v, lengths):
    """q (B, Hq, D) f32; k, v (B, T, Hkv, D); lengths (B,) -> (B, Hq, D) f32
    attending [0, lengths[b]] inclusive."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float())
    mask = torch.arange(T, device=q.device)[None, :] <= lengths[:, None]
    s = (s * D ** -0.5).masked_fill(~mask[:, None, None, :], NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, Hq, D)


def decode_partials_plain(q, k, v, lengths, n_splits: int):
    """The kernel's function: per-split partials (o (B, ns, Hq, D),
    m (B, ns, Hq), l (B, ns, Hq)), all f32, o unnormalised."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G, ns = Hq // Hkv, n_splits
    tc = -(-T // ns)
    pad = ns * tc - T
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, kp.float()) * D ** -0.5
    pos = torch.arange(ns * tc, device=q.device)
    mask = (pos[None, :] <= lengths[:, None]) & (pos < T)[None, :]
    s = s.masked_fill(~mask[:, None, None, :], NEG)
    s = s.reshape(B, Hkv, G, ns, tc)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = p.to(v.dtype).float()
    o = torch.einsum("bkgst,bstkd->bskgd", pv,
                     vp.float().reshape(B, ns, tc, Hkv, D))
    return (o.reshape(B, ns, Hq, D),
            m.permute(0, 3, 1, 2).reshape(B, ns, Hq),
            l.permute(0, 3, 1, 2).reshape(B, ns, Hq))


def combine_splits(o, m, l):
    """(B,ns,Hq,D),(B,ns,Hq),(B,ns,Hq) -> (B,Hq,D) flash merge."""
    m_g = m.amax(dim=1, keepdim=True)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=1)
    o_g = (o * corr[..., None]).sum(dim=1)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def decode_attention_cuda(lib, q, k, v, lengths, n_splits: int):
    """Launch the kernel on ``q``'s current stream; same result as
    ``combine_splits(*decode_partials_plain(q, k, v, lengths, n_splits))``.
    Each split is a block, and the blocks of a (kv head, row) form a thread
    block cluster of ``min(n_splits, 16)`` blocks that merges the splits."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError("decode_attention kernel: inputs must be on one CUDA "
                         "device")
    if q.dtype != torch.float32 or k.dtype != v.dtype or \
            k.dtype not in _KV_DTYPES:
        raise TypeError(f"decode_attention kernel: q f32 and k, v f32/bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"decode_attention kernel: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if lengths.shape != (B,) or n_splits < 1:
        raise ValueError("decode_attention kernel: lengths (B,), n_splits >= 1")
    Dp = -(-D // 8) * 8
    if Dp != D:
        # the kernel takes D in steps of 8: zero columns leave every score
        # and the first D output columns as they are
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    q, k, v = (aligned16(t, contiguous=True) for t in (q, k, v))
    if lengths.dtype != torch.int32 or lengths.stride(0) != 1:
        lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, Hq, Dp), dtype=torch.float32, device=q.device)
    err = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        _KV_DTYPES[k.dtype], B, T, Hq, Hkv, Dp, n_splits, D ** -0.5,
        o.data_ptr(), torch._C._cuda_getCurrentRawStream(q.device.index))
    if err == 1:  # cudaErrorInvalidValue once the shapes passed the checks
        raise ValueError("decode_attention kernel: splits too long for shared "
                         "memory (raise n_splits) or too many heads for the "
                         "grid")
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o if Dp == D else o[..., :D]
