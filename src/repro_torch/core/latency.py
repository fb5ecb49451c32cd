"""Latency models + measurement helpers (Fig 3 / Table 1 reproduction),
the port's copy of the JAX package's ``core/latency.py``.

Two latency sources can be reported side by side:
  * MEASURED — wall-clock of the port's components on the card (vector
    search over the real store, the LM engine); ``measure`` synchronises
    CUDA before it reads each clock, so it times the work on the card and
    not only its launches.
  * MODELED  — the paper's H100 operating point, from a standard two-phase
    analytic model:
        prefill_time = 2 * N * C / (peak_flops * mfu)
        decode_time  = n_out * bytes(N) / hbm_bw   (memory-bound decode)
    which reproduces Fig 3's trend (LLM latency grows with context size,
    vector search flat).

``effective_latency`` implements the paper's §4 definition verbatim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class HwPoint:
    name: str
    peak_flops: float          # dense (f16/bf16) FLOP/s
    hbm_bw: float              # bytes/s
    mfu_prefill: float = 0.45
    kv_bytes_per_tok: float = 0.0


H100 = HwPoint("h100-sxm", 989e12, 3.35e12)


def llm_latency(hw: HwPoint, n_params: float, ctx_tokens: int,
                out_tokens: int, dtype_bytes: float = 2.0) -> dict:
    prefill = 2.0 * n_params * ctx_tokens / (hw.peak_flops * hw.mfu_prefill)
    per_tok = (n_params * dtype_bytes
               + hw.kv_bytes_per_tok * ctx_tokens) / hw.hbm_bw
    decode = out_tokens * per_tok
    return {"prefill_s": prefill, "decode_s": decode,
            "total_s": prefill + decode}


def effective_latency(hit_rate: float, search_s: float, llm_s: float):
    """Paper §4: hit*search + miss*llm (parallel execution makes the miss
    path cost exactly the plain-LLM latency)."""
    return hit_rate * search_s + (1.0 - hit_rate) * llm_s


def _sync():
    """Wait for the card's queued work (a no-op without CUDA)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable, *args, repeat: int = 5, warmup: int = 2) -> dict:
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(repeat):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    import numpy as np
    return {"mean_s": float(np.mean(ts)), "p50_s": float(np.median(ts)),
            "min_s": float(np.min(ts)), "max_s": float(np.max(ts))}
