"""B1 ``mips_topk``: exact MIPS of an f32 query block against a float
store, emitted as per-tile top-k candidates.

The CUDA kernel (``csrc/mips_topk.cu``) replaces the JAX package's
``kernels/mips_topk.py:mips_topk_pallas``. ``mips_topk_tiles_plain`` is the
same function in plain PyTorch: the CPU path of ``ops.mips_topk`` and what
the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import topk_by_value

NEG = -1e30

# ctypes signature of the C entry in csrc/mips_topk.cu
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_X_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def mips_topk_tiles_plain(q: torch.Tensor, x: torch.Tensor, k: int,
                          tile_n: int):
    """q (Q, D) f32; x (N, D) float -> per-tile candidates
    (vals (nt, Q, k) f32, global idx (nt, Q, k) int32): the exact top k of
    every tile of ``tile_n`` rows in (value desc, index asc) order, rows
    >= N scoring -1e30."""
    Q, N = q.shape[0], x.shape[0]
    nt = -(-N // tile_n)
    s = q.float() @ x.float().T                               # (Q, N)
    s = torch.nn.functional.pad(s, (0, nt * tile_n - N), value=NEG)
    s = s.reshape(Q, nt, tile_n).transpose(0, 1)               # (nt, Q, tile)
    vals, idx = topk_by_value(s, k)
    offs = torch.arange(nt, dtype=torch.int32, device=q.device) * tile_n
    return vals.contiguous(), (idx + offs[:, None, None]).contiguous()


def mips_topk_tiles_cuda(lib, q: torch.Tensor, x: torch.Tensor, k: int,
                         tile_n: int):
    """Launch the kernel on ``q``'s current stream; same result as
    ``mips_topk_tiles_plain``."""
    if not (q.is_cuda and x.is_cuda and q.device == x.device):
        raise ValueError("mips_topk kernel: q and x must be on one CUDA device")
    if q.dtype != torch.float32 or x.dtype not in _X_DTYPES:
        raise TypeError(f"mips_topk kernel: q must be f32 and x f32/f16/bf16, "
                        f"got {q.dtype} and {x.dtype}")
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"mips_topk kernel: shapes {tuple(q.shape)} and "
                         f"{tuple(x.shape)}")
    q, x = q.contiguous(), x.contiguous()
    Q, D = q.shape
    N = x.shape[0]
    if not 1 <= k <= tile_n:
        raise ValueError(f"mips_topk kernel: need 1 <= k={k} <= "
                         f"tile_n={tile_n}")
    qb = 8 if Q <= 8 else 32
    smem = 4 * (32 * 256 + 32 * qb + qb * tile_n)
    if smem > 227 * 1024:
        raise ValueError(f"mips_topk kernel: tile_n={tile_n} needs {smem} B "
                         "of shared memory per block")
    nt = -(-N // tile_n)
    vals = torch.empty((nt, Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nt, Q, k), dtype=torch.int32, device=q.device)
    vec_ok = int(x.data_ptr() % 16 == 0 and (D * x.element_size()) % 16 == 0)
    err = lib.mips_topk(q.data_ptr(), x.data_ptr(), _X_DTYPES[x.dtype], Q, D,
                        N, k, tile_n, vec_ok, vals.data_ptr(), idx.data_ptr(),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mips_topk kernel launch failed: CUDA error {err}")
    return vals, idx
