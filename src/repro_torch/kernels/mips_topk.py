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
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
            + [ctypes.c_void_p] * 3)
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


def granule(t: torch.Tensor) -> int:
    """The largest of 16, 8 and 4 bytes that divides both the row bytes of
    the 2-D contiguous ``t`` and its address (the kernels' cp.async size),
    or 0: such rows are read with plain loads."""
    rb = t.shape[1] * t.element_size()
    for g in (16, 8, 4):
        if rb % g == 0 and t.data_ptr() % g == 0:
            return g
    return 0


def launch_error(name: str, err: int, tile_n: int):
    """The exception for a nonzero cudaError_t from a search kernel."""
    if err == 1:  # cudaErrorInvalidValue once the shapes passed the checks
        return ValueError(f"{name} kernel: tile_n={tile_n} needs more shared "
                          "memory per block than the card has (k > 1 keeps "
                          "a [32][tile_n] score table), or N or Q is out of "
                          "the kernel's range")
    return RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


CONFIG_KEYS = ("grid_x", "grid_y", "threads", "blocks_per_sm", "registers",
               "local_bytes", "smem_bytes")


def read_config(name: str, err: int, out, tile_n: int) -> dict:
    """The launch configuration a ``*_config`` C entry wrote into ``out``:
    grid, threads, blocks per SM, registers, spilled (local) bytes per
    thread, dynamic shared memory per block."""
    if err:
        raise launch_error(name, err, tile_n)
    return dict(zip(CONFIG_KEYS, list(out)))


def launch_config(lib, x_dtype: torch.dtype, Q: int, D: int, N: int, k: int,
                  tile_n: int) -> dict:
    """The launch configuration ``mips_topk_tiles_cuda`` gets for these
    shapes (``read_config``)."""
    fn = lib.mips_topk_config
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(CONFIG_KEYS))()
    err = fn(_X_DTYPES[x_dtype], Q, D, N, k, tile_n, ctypes.addressof(out))
    return read_config("mips_topk", err, out, tile_n)


def mips_topk_tiles_cuda(lib, q: torch.Tensor, x: torch.Tensor, k: int,
                         tile_n: int):
    """Launch the kernel on ``q``'s current stream; same result as
    ``mips_topk_tiles_plain``. Copies nothing of ``x`` (a contiguous
    store); any D runs, the kernel zero-fills depth past D."""
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
    nt = -(-N // tile_n)
    vals = torch.empty((nt, Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nt, Q, k), dtype=torch.int32, device=q.device)
    err = lib.mips_topk(q.data_ptr(), x.data_ptr(), _X_DTYPES[x.dtype], Q, D,
                        N, k, tile_n, granule(x), granule(q),
                        vals.data_ptr(), idx.data_ptr(),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise launch_error("mips_topk", err, tile_n)
    return vals, idx
