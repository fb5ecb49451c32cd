"""Public wrappers around the port's CUDA kernels, their build and load,
and one launch counter per kernel.

Each wrapper launches its hand-written kernel when its tensors lie on a
CUDA device and raises if the kernel cannot run; it takes the kernel's
plain PyTorch version only because its tensors lie on the CPU (the tests
here) or on the meta device, which has no data and computes shapes only
(the dry run, ``launch/dryrun.py``). There is no fallback from a CUDA
tensor to the plain version, and tensors on two devices raise.

Under an active cost counter (``launch/costs.py``) each wrapper credits
its call with the function's own work (``*_work`` below): its FLOPs (int8
ops for B2) and its least bytes, each operand read once and its output
written once; the counter then skips the ops inside, so a call counts the
same on the CPU, on meta and on the card.

The kernels are CUDA C++ for ``sm_90a`` in ``src/repro_torch/csrc``. At
first use each source is compiled by ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` of the checkout (all
sources at once, in parallel) and loaded with ``ctypes``; a library is
rebuilt when its source, header or flags change. A failed build raises with
the compiler's output. An installed package (the sources ship in the
wheel as package data) builds into a per-user cache directory instead,
as does a checkout whose ``build/`` cannot be written.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mips_topk as _mt
from repro_torch.kernels import mips_topk_int8 as _mt8
from repro_torch.launch import costs as _costs

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir() -> Path:
    """``build/kernels`` of the checkout when the package sits in one
    (``<root>/src/repro_torch``) and that ``build/`` can be written, else
    ``$XDG_CACHE_HOME/repro_torch/kernels`` (``~/.cache`` by default)."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and \
            Path(__file__).resolve().parents[2].name == "src":
        build = root / "build"
        if os.access(build if build.exists() else root, os.W_OK):
            return build / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or \
        str(Path.home() / ".cache")
    return Path(cache) / "repro_torch" / "kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# kernel name -> (source, ctypes argtypes)
KERNELS = {
    "mips_topk": ("mips_topk.cu", _mt.ARGTYPES),
    "mips_topk_int8": ("mips_topk_int8.cu", _mt8.ARGTYPES),
    "decode_attention": ("decode_attention.cu", _da.ARGTYPES),
    "flash_attention": ("flash_attention.cu", _fa.ARGTYPES),
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
    CPU or every one on meta (shapes only); a mix is an error, never a
    fallback."""
    if all(t.is_cuda for t in ts):
        return True
    if all(t.device.type == "cpu" for t in ts) or \
            all(t.device.type == "meta" for t in ts):
        return False
    raise ValueError("kernel inputs must all lie on one CUDA device, all "
                     "on the CPU or all on meta, got "
                     + ", ".join(str(t.device) for t in ts))


def _launch(wrapper, ts, kernel, plain, work):
    """``kernel()`` when the tensors ``ts`` lie on CUDA (one launch
    counted), else ``plain()``; under an active cost counter the call is
    credited with ``work()`` = (FLOPs, bytes, product dtype)."""
    cuda = _on_cuda(*ts)
    c = _costs.active()
    with contextlib.nullcontext() if c is None else \
            c.kernel(wrapper.__name__, work):
        if not cuda:
            return plain()
        out = kernel()
        _count(wrapper)
        return out


# ---------------------------------------------------------------------------
# Each kernel's own work: (FLOPs, least bytes)
# ---------------------------------------------------------------------------


def _nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mips_work(q, x, k: int, tile_n: int, *scales):
    """B1 and B2 (the tile scan): 2 Q N D, reading q, x and B2's
    ``scales`` once and writing each tile's k candidates (f32 value,
    int32 id)."""
    (Q, D), N = q.shape, x.shape[0]
    return 2 * Q * N * D, _nb(q, x, *scales) + -(-N // tile_n) * Q * k * 8


def decode_work(q, k, v, lengths):
    """B3: 2 D (q.k) + 2 D (p.v) per attended (row, head) pair, reading q,
    the lengths and the attended rows of k and v once and writing the f32
    output. The attended rows are ``min(lengths[b], T - 1) + 1`` of each
    sequence where the lengths are known; on meta, which holds none, all
    T."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    att = B * T if lengths.device.type == "meta" else \
        int((lengths.clamp(max=T - 1) + 1).sum())
    kv = att * Hkv * (k.shape[3] * k.element_size() +
                      v.shape[3] * v.element_size())
    return 2 * att * Hq * (D + v.shape[3]), _nb(q, lengths) + kv + \
        B * Hq * v.shape[3] * 4


def flash_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs a flash forward scores: all S T, or the causal
    lower triangle (key j <= query i)."""
    if not causal:
        return S * T
    n = min(S, T)
    return n * (n + 1) // 2 + (S - n) * T


def flash_work(q, k, v, causal: bool):
    """B4: 2 D (q.k) + 2 Dv (p.v) per scored pair and head, reading q, k
    and v once and writing the output (q's dtype, Dv wide)."""
    B, S, Hq, D = q.shape
    Dv = v.shape[3]
    pairs = flash_pairs(S, k.shape[1], causal)
    return 2 * B * Hq * pairs * (D + Dv), _nb(q, k, v) + \
        B * S * Hq * Dv * q.element_size()


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

    vals, idx = _launch(
        mips_topk, (q, x),
        lambda: _mt.mips_topk_tiles_cuda(_lib("mips_topk"), q, x, k, tile_n),
        lambda: _mt.mips_topk_tiles_plain(q, x, k, tile_n),
        lambda: mips_work(q, x, k, tile_n) + (q.dtype,))
    return _combine_tiles(vals, idx, k)


def mips_topk_int8(q, q_scale, x, x_scale, k: int, tile_n: int = 512):
    """Quantized exact-over-the-quantized-grid MIPS: q (Q,D) int8 with
    per-row f32 ``q_scale`` (Q,), x (N,D) int8 with per-row ``x_scale``
    (N,) -> (dequantized vals (Q,k), GLOBAL idx (Q,k)). Same clamping and
    combine as ``mips_topk``; bit-for-bit against ref.mips_topk_int8_ref."""
    k = int(k)
    tile_n = _clamp_tile(x.shape[0], k, int(tile_n))

    vals, idx = _launch(
        mips_topk_int8, (q, q_scale, x, x_scale),
        lambda: _mt8.mips_topk_int8_tiles_cuda(
            _lib("mips_topk_int8"), q, q_scale, x, x_scale, k, tile_n),
        lambda: _mt8.mips_topk_int8_tiles_plain(q, q_scale, x, x_scale, k,
                                                tile_n),
        lambda: mips_work(q, x, k, tile_n, q_scale, x_scale) + (q.dtype,))
    return _combine_tiles(vals, idx, k)


def decode_attention(q, k, v, lengths, n_splits: int = 8):
    """q: (B,Hq,D) f32; k,v: (B,T,Hkv,D) f32/bf16; lengths (B,) ->
    (B,Hq,D) f32 attending [0, lengths[b]] inclusive."""
    return _launch(
        decode_attention, (q, k, v, lengths),
        lambda: _da.decode_attention_cuda(_lib("decode_attention"), q, k, v,
                                          lengths, int(n_splits)),
        lambda: _da.decode_attention_plain(q, k, v, lengths),
        lambda: decode_work(q, k, v, lengths) + (q.dtype,))


def flash_attention(q, k, v, causal: bool = True):
    """Model layout: q (B,S,Hq,D); k (B,T,Hkv,D), v (B,T,Hkv,Dv), Dv <= D
    -> (B,S,Hq,Dv); causal masks key j > query i (offset 0), non-causal
    attends to all T keys."""
    return _launch(
        flash_attention, (q, k, v),
        lambda: _fa.flash_attention_cuda(_lib("flash_attention"), q, k, v,
                                         causal),
        lambda: _fa.flash_attention_plain(q, k, v, causal),
        lambda: flash_work(q, k, v, causal) + (q.dtype,))


_WRAPPERS = (mips_topk, mips_topk_int8, decode_attention, flash_attention)
for _f in _WRAPPERS:
    _f.launches = 0
