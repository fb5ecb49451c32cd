"""B4 ``flash_attention``: causal or non-causal grouped-query attention over
a full sequence, in the model's layout (q (B,S,Hq,D), k and v (B,T,Hkv,D)).

The CUDA kernel (``csrc/flash_attention.cu``) replaces the JAX package's
``kernels/flash_attention.py:flash_attention_pallas``. It reads the model's
layout through strides, so the head-major transposes of the reference's
``ops.flash_attention`` have no counterpart here. It carries the engine's
prefill (causal) and the MiniLM encoder's layers (non-causal; the encoder
attends to its padding tokens, as the reference does, so there is no
key-padding mask). The values may be narrower than the queries and keys
(MLA's prefill: q/k 192 wide, v 128): the wrapper zero-pads v to the
q/k width and returns the first ``v.shape[-1]`` output columns, which is
exact, since an output column is the probabilities times that one value
column.

``flash_attention_plain`` is the naive math the reference runs for the
same call sites (its ``models/layers.py:gqa_scores_softmax_out``, here
``kernels/ref.py``'s, with the causal mask at offset 0): f32 scores, f32
softmax, probabilities cast to v's dtype before P.V. It is the CPU path of
``ops.flash_attention`` and what the kernel is held against on the card.
With f32 inputs the two agree to summation order and the kernel's 3xTF32
products (about 2^-21 relative each); with bf16 inputs the plain version
rounds the scores to bf16 (the einsum's output dtype) and the normalised
probability, the kernel neither the scores and only the unnormalised
``exp(s - m)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import causal_mask, gqa_scores_softmax_out

MAX_HEAD_DIM = 256

ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


def flash_attention_plain(q, k, v, causal: bool = True):
    """q (B,S,Hq,D), k (B,T,Hkv,D), v (B,T,Hkv,Dv) -> (B,S,Hq,Dv) in v's
    dtype; query row i attends key j when j < T and, if ``causal``,
    j <= i."""
    mask = causal_mask(q.shape[1], k.shape[1], 0, q.device) if causal \
        else None
    return gqa_scores_softmax_out(q, k, v, mask, q.shape[-1] ** -0.5)


def flash_attention_cuda(lib, q, k, v, causal: bool = True):
    """Launch the kernel on ``q``'s current stream; same function as
    ``flash_attention_plain`` (v's width ``Dv`` <= the q/k width), output
    in q's dtype (the reference's)."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention kernel: inputs must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: q, k, v all f32 or all "
                        f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention kernel: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, T, Hkv, D) or v.shape[:3] != k.shape[:3] or \
            not 1 <= Dv <= D or Hq % Hkv or min(S, T) < 1:
        raise ValueError(f"flash_attention kernel: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    Dp = -(-D // 8) * 8
    if Dp != D:
        # the kernel takes D in steps of 8: zero columns leave every score
        # and the first D output columns as they are
        q, k = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k))
    if Dp != Dv:
        # narrower values are zero-padded to the kernel's one width
        v = torch.nn.functional.pad(v, (0, Dp - Dv))
    q, k, v = (aligned16(t) for t in (q, k, v))
    o = torch.empty((B, S, Hq, Dp), dtype=q.dtype, device=q.device)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, S, T, Hq, Hkv, Dp, int(bool(causal)), D ** -0.5,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o if Dp == Dv else o[..., :Dv]


def aligned16(t, contiguous: bool = False):
    """``t`` itself when a kernel can read it in 16-byte pieces (the pointer
    a multiple of 16 bytes; contiguous, or with ``contiguous=False`` a unit
    innermost stride and the other strides multiples of 16 bytes), else a
    contiguous copy. B3 takes contiguous inputs, B4 strided ones."""
    es = t.element_size()
    if t.data_ptr() % 16 == 0 and (
            t.is_contiguous() if contiguous else
            t.stride(-1) == 1 and
            all(st * es % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)
