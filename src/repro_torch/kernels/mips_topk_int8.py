"""B2 ``mips_topk_int8``: int8 query x int8 store MIPS with exact int32
accumulation and fused per-row dequant, emitted as per-tile top-k
candidates.

The CUDA kernel (``csrc/mips_topk_int8.cu``) replaces the JAX package's
``kernels/mips_topk_int8.py:mips_topk_int8_pallas``.
``mips_topk_int8_tiles_plain`` is the same function in plain PyTorch, bit
for bit: the CPU path of ``ops.mips_topk_int8`` and what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.mips_topk import (CONFIG_KEYS, granule,
                                           launch_error, read_config)
from repro_torch.kernels.ref import topk_by_value

NEG = -1e30

ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3)


def int8_scores_plain(q, q_scale, x, x_scale):
    """(Q, N) dequantized scores: the int8 dot products are computed in
    float64, where every partial sum of int8 products is an exact integer
    (|s| < 2^53), then rounded to f32 — exactly the int32 -> f32 cast of
    the reference — and scaled by q_scale, then x_scale, in f32."""
    s = (q.double() @ x.double().T).float()
    s = s * q_scale.float()[:, None]
    return s * x_scale.float()[None, :]


def mips_topk_int8_tiles_plain(q, q_scale, x, x_scale, k: int, tile_n: int):
    """q (Q, D) int8 + (Q,) f32; x (N, D) int8 + (N,) f32 -> per-tile
    candidates (vals (nt, Q, k) f32, global idx (nt, Q, k) int32)."""
    Q, N = q.shape[0], x.shape[0]
    nt = -(-N // tile_n)
    s = int8_scores_plain(q, q_scale, x, x_scale)
    s = torch.nn.functional.pad(s, (0, nt * tile_n - N), value=NEG)
    s = s.reshape(Q, nt, tile_n).transpose(0, 1)
    vals, idx = topk_by_value(s, k)
    offs = torch.arange(nt, dtype=torch.int32, device=q.device) * tile_n
    return vals.contiguous(), (idx + offs[:, None, None]).contiguous()


def launch_config(lib, Q: int, D: int, N: int, k: int, tile_n: int) -> dict:
    """The launch configuration ``mips_topk_int8_tiles_cuda`` gets for
    these shapes (``mips_topk.read_config``)."""
    fn = lib.mips_topk_int8_config
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(CONFIG_KEYS))()
    err = fn(Q, D, N, k, tile_n, ctypes.addressof(out))
    return read_config("mips_topk_int8", err, out, tile_n)


def mips_topk_int8_tiles_cuda(lib, q, q_scale, x, x_scale, k: int,
                              tile_n: int):
    """Launch the kernel on ``q``'s current stream; same result as
    ``mips_topk_int8_tiles_plain``. Copies nothing of ``x`` (a contiguous
    store) on any D: the kernel zero-fills depth past D in shared
    memory."""
    ts = (q, q_scale, x, x_scale)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("mips_topk_int8 kernel: inputs must be on one CUDA "
                         "device")
    if q.dtype != torch.int8 or x.dtype != torch.int8:
        raise TypeError("mips_topk_int8 kernel: q and x must be int8")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"mips_topk_int8 kernel: shapes {tuple(q.shape)} "
                         f"and {tuple(x.shape)}")
    Q, D = q.shape
    N = x.shape[0]
    if q_scale.shape != (Q,) or x_scale.shape != (N,):
        raise ValueError("mips_topk_int8 kernel: one scale per row")
    if not 1 <= k <= tile_n:
        raise ValueError(f"mips_topk_int8 kernel: need 1 <= k={k} <= "
                         f"tile_n={tile_n}")
    q, x = q.contiguous(), x.contiguous()
    q_scale = q_scale.float().contiguous()
    x_scale = x_scale.float().contiguous()
    nt = -(-N // tile_n)
    vals = torch.empty((nt, Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nt, Q, k), dtype=torch.int32, device=q.device)
    err = lib.mips_topk_int8(q.data_ptr(), q_scale.data_ptr(), x.data_ptr(),
                             x_scale.data_ptr(), Q, D, N, k, tile_n,
                             granule(x), granule(q), vals.data_ptr(),
                             idx.data_ptr(),
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise launch_error("mips_topk_int8", err, tile_n)
    return vals, idx
