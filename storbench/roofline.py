"""The yardstick's peaks and each kernel's least time, from a call's
shapes alone.

Peaks: one NVIDIA H100 SXM5 at its 700 W limit (the data sheet, dense):
HBM3 at 3.35 TB/s, TF32 tensor cores at 495 TFLOP/s, f32 on the CUDA
cores at 67 TFLOP/s, bf16 at 989 TFLOP/s. The work functions are copies
of the port's credit arithmetic (``kernels/ops.py``: ``mips_work``,
``decode_work``, ``flash_work``), checked against the card in
``chip_smoke.py`` phase 19 (c), and the bound rules are PERF.md §6's: an
f32 product on tensor cores at full f32 accuracy takes three TF32
products (3xTF32), one of an fp16 store two (2xTF32), since fp16 values
are exact in TF32. A least time is the larger of operations over that
rate and the least bytes (each operand read once, each output written
once) over the HBM bandwidth, so a share of it never passes 100% unless
the time leaves out work.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

_ITEM = {"float32": 4, "float16": 2, "bfloat16": 2, "int32": 4, "int64": 8,
         "int8": 1}


def least_s(nbytes: float, ops: float, rate: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / rate)


def mips_topk_s(Q: int, N: int, D: int, k: int, tile_n: int, q_dtype: str,
                x_dtype: str) -> float:
    """B1: 2 Q N D products; q and x read once, each tile's k candidates
    (f32 value, int32 id) written. 2xTF32 for an fp16/bf16 store, 3xTF32
    for an f32 one."""
    tile_n = max(min(tile_n, -(-N // 128) * 128), k)
    flops = 2 * Q * N * D
    nbytes = Q * D * _ITEM[q_dtype] + N * D * _ITEM[x_dtype] \
        + -(-N // tile_n) * Q * k * 8
    passes = 3 if x_dtype == "float32" else 2
    return least_s(nbytes, passes * flops, TF32_FLOPS)


def decode_attention_s(B: int, Hq: int, D: int, T: int, Hkv: int, Dv: int,
                       attended: int, q_dtype: str, kv_dtype: str) -> float:
    """B3: 2 (D + Dv) per attended (row, head) pair on the CUDA cores; q,
    the lengths and the attended rows of k and v read once, the f32 output
    written. ``attended`` is the sum over rows of min(length, T - 1) + 1."""
    flops = 2 * attended * Hq * (D + Dv)
    nbytes = B * Hq * D * _ITEM[q_dtype] + B * 4 \
        + attended * Hkv * (D + Dv) * _ITEM[kv_dtype] + B * Hq * Dv * 4
    return least_s(nbytes, flops, F32_FLOPS)


def flash_pairs(S: int, T: int, causal: bool) -> int:
    if not causal:
        return S * T
    n = min(S, T)
    return n * (n + 1) // 2 + (S - n) * T


def flash_attention_s(B: int, S: int, Hq: int, D: int, T: int, Hkv: int,
                      Dv: int, causal: bool, dtype: str) -> float:
    """B4: 2 (D + Dv) per scored pair and head; q, k and v read once, the
    output (q's dtype, Dv wide) written. f32 at 3xTF32, bf16 at its rate."""
    flops = 2 * B * Hq * flash_pairs(S, T, causal) * (D + Dv)
    it = _ITEM[dtype]
    nbytes = (B * S * Hq * D + B * T * Hkv * (D + Dv)) * it \
        + B * S * Hq * Dv * it
    if dtype == "float32":
        return least_s(nbytes, 3 * flops, TF32_FLOPS)
    return least_s(nbytes, flops, BF16_FLOPS)
