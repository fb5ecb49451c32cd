"""Device time of the two search kernels (B1 ``mips_topk``, B2
``mips_topk_int8``) at the shapes of ``tests/test_torch_gpu.py``'s
``MIPS_SHAPES`` and at the paper's store, on one NVIDIA GPU, through the
port's wrappers as a checkout's ``src`` has them:

    python tools/search_shapes.py [--src DIR]

``--src`` defaults to this checkout's ``src``. To compare two versions on
one card, unpack the other one (``git archive <commit> src | tar -x -C
build/other``) and run both in one call, in turns: other, this, this,
other. Each run builds its kernels into its own checkout's
``build/kernels``. Times are device ms per call from a ``torch.profiler``
trace (no L2 flush; the paper's store is larger than L2), after a warm-up.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MIPS_SHAPES = [  # (Q, N, D, k, tile), as tests/test_torch_gpu.py
    (4, 100, 16, 5, 32),
    (8, 512, 384, 10, 128),
    (1, 33, 24, 3, 32),
    (16, 1024, 64, 16, 512),
    (2, 300, 100, 32, 32),
    (1, 64, 48, 64, 512),
    (3, 200, 384, 1, 128),
]
PAPER = [(32, 150000, 384, 1, 512), (8, 150000, 384, 1, 512),
         (1, 150000, 384, 1, 512)]


def device_ms(torch, fn, iters):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if "mips_t" in e.key)
    if us <= 0:
        raise SystemExit("the profiler saw no search kernel")
    return us / iters / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("search_shapes.py runs only on a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import mips_topk as mt
    from repro_torch.kernels import mips_topk_int8 as mt8
    from repro_torch.kernels import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; src {args.src}; device ms per call, profiler")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lib1, lib2 = ops._lib("mips_topk"), ops._lib("mips_topk_int8")
    for Q, N, D, k, tile in MIPS_SHAPES + PAPER:
        tile = ops._clamp_tile(N, k, tile)
        iters = 20 if N > 10000 else 100
        q = torch.randn((Q, D), generator=g, device=dev)
        cells = []
        for dt in (torch.float16, torch.bfloat16, torch.float32):
            x = torch.randn((N, D), generator=g, device=dev).to(dt)
            ms = device_ms(torch, lambda: mt.mips_topk_tiles_cuda(
                lib1, q, x, k, tile), iters)
            cells.append(f"B1 {str(dt).split('.')[-1]} {ms:.4f}")
        q8, x8 = (torch.randint(-127, 128, (n, D), generator=g, device=dev,
                                dtype=torch.int8) for n in (Q, N))
        qs, xs = (torch.rand((n,), generator=g, device=dev) for n in (Q, N))
        ms = device_ms(torch, lambda: mt8.mips_topk_int8_tiles_cuda(
            lib2, q8, qs, x8, xs, k, tile), iters)
        cells.append(f"B2 {ms:.4f}")
        print(f"Q={Q} N={N} D={D} k={k} tile={tile}: " + " | ".join(cells),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
