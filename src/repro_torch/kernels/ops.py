"""Public wrappers around the port's CUDA kernels, their build and load,
and one launch counter per kernel.

Each wrapper launches its hand-written kernel when its tensors lie on a
CUDA device and raises if the kernel cannot run; it takes the kernel's
plain PyTorch version only because its tensors lie on the CPU (the tests
here). There is no fallback from a CUDA tensor to the plain version.

The kernels are CUDA C++ for ``sm_90a`` in ``src/repro_torch/csrc``. At
first use each source is compiled by ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` of the checkout (all
sources at once, in parallel) and loaded with ``ctypes``; a library is
rebuilt when its source, header or flags change. A failed build raises with
the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import mips_topk as _mt
from repro_torch.kernels import mips_topk_int8 as _mt8

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# kernel name -> (source, ctypes argtypes)
KERNELS = {
    "mips_topk": ("mips_topk.cu", _mt.ARGTYPES),
    "mips_topk_int8": ("mips_topk_int8.cu", _mt8.ARGTYPES),
    "decode_attention": ("decode_attention.cu", _da.ARGTYPES),
}

_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [str(Path(CUDA_HOME) / "bin" / "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.name == KERNELS[name][0]:
            h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns each kernel's
    ``-Xptxas -v`` report (registers, shared memory, spills), read back
    from the build log when the library was already there."""
    names = list(KERNELS) if names is None else list(names)
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / KERNELS[name][0])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            log = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return {n: _lib_path(n).with_suffix(".log").read_text() for n in names
            if _lib_path(n).with_suffix(".log").exists()}


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_kernels([name])
        with _build_lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                fn = getattr(lib, name)
                fn.argtypes = KERNELS[name][1]
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches made through the wrappers since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts():
    with _count_lock:
        for f in _WRAPPERS:
            f.launches = 0


def _on_cuda(*ts) -> bool:
    """True when every tensor is on CUDA, False when every one is on the
    CPU; a mix is an error, never a fallback."""
    if all(t.is_cuda for t in ts):
        return True
    if all(t.device.type == "cpu" for t in ts):
        return False
    raise ValueError("kernel inputs must all lie on one CUDA device or all "
                     "on the CPU, got " + ", ".join(str(t.device) for t in ts))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _combine_tiles(vals, idx, k):
    """Reduce per-tile candidates (nt, Q, k) to the global top-k. Tiles are
    flattened in (tile, rank) order, which is (value desc, index asc)
    within a tile and index-asc across tiles — so a STABLE descending sort
    keeps the kernels' (value desc, index asc) contract end to end
    (``torch.topk`` promises no order among equal values)."""
    nt, Q = vals.shape[0], vals.shape[1]
    vflat = vals.transpose(0, 1).reshape(Q, nt * k)
    iflat = idx.transpose(0, 1).reshape(Q, nt * k)
    v, pos = torch.sort(vflat, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(iflat, 1, pos[:, :k])


def _clamp_tile(n: int, k: int, tile_n: int) -> int:
    """``tile_n`` clamped to the (128-aligned) store size so small stores
    don't scan a mostly-padded tile; the per-tile top-k needs k <= tile_n."""
    if k > n:
        raise ValueError(f"k={k} exceeds store rows N={n}")
    return max(min(tile_n, -(-n // 128) * 128), k)


def mips_topk(q: torch.Tensor, x: torch.Tensor, k: int, tile_n: int = 512):
    """q: (Q,D) f32; x: (N,D) f32/f16/bf16 -> exact (vals (Q,k) f32,
    GLOBAL idx (Q,k) int32) in (value desc, index asc) order."""
    k = int(k)
    tile_n = _clamp_tile(x.shape[0], k, int(tile_n))
    if _on_cuda(q, x):
        vals, idx = _mt.mips_topk_tiles_cuda(_lib("mips_topk"), q, x, k,
                                             tile_n)
        _count(mips_topk)
    else:
        vals, idx = _mt.mips_topk_tiles_plain(q, x, k, tile_n)
    return _combine_tiles(vals, idx, k)


def mips_topk_int8(q, q_scale, x, x_scale, k: int, tile_n: int = 512):
    """Quantized exact-over-the-quantized-grid MIPS: q (Q,D) int8 with
    per-row f32 ``q_scale`` (Q,), x (N,D) int8 with per-row ``x_scale``
    (N,) -> (dequantized vals (Q,k), GLOBAL idx (Q,k)). Same clamping and
    combine as ``mips_topk``; bit-for-bit against ref.mips_topk_int8_ref."""
    k = int(k)
    tile_n = _clamp_tile(x.shape[0], k, int(tile_n))
    if _on_cuda(q, q_scale, x, x_scale):
        vals, idx = _mt8.mips_topk_int8_tiles_cuda(
            _lib("mips_topk_int8"), q, q_scale, x, x_scale, k, tile_n)
        _count(mips_topk_int8)
    else:
        vals, idx = _mt8.mips_topk_int8_tiles_plain(q, q_scale, x, x_scale,
                                                    k, tile_n)
    return _combine_tiles(vals, idx, k)


def decode_attention(q, k, v, lengths, n_splits: int = 8):
    """q: (B,Hq,D) f32; k,v: (B,T,Hkv,D) f32/bf16; lengths (B,) ->
    (B,Hq,D) f32 attending [0, lengths[b]] inclusive."""
    if _on_cuda(q, k, v, lengths):
        o, m, l = _da.decode_partials_cuda(_lib("decode_attention"), q, k, v,
                                           lengths, int(n_splits))
        _count(decode_attention)
        return _da.combine_splits(o, m, l)
    return _da.decode_attention_plain(q, k, v, lengths)


_WRAPPERS = (mips_topk, mips_topk_int8, decode_attention)
for _f in _WRAPPERS:
    _f.launches = 0
