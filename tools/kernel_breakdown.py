"""Where a port kernel's time goes, on one NVIDIA GPU: times the kernel as
built from ``src/repro_torch/csrc`` beside copies of its source with one
part switched off, at the shapes the serving path gives it.

    python tools/kernel_breakdown.py

Each copy is compiled by its own ``nvcc`` (all at once) into
``build/breakdown/`` and loaded with ``ctypes``; times are device time per
call from a ``torch.profiler`` trace, after a warm-up. A copy with a part
off computes a wrong result and only its time is read; the difference
between two rows is what that part costs where it lies on the kernel's
critical path. The switches edit the source at fixed anchor lines and
fail when an anchor is gone, so a change to the kernels shows here as an
error, not as a silent no-op (``tests/test_torch_tools.py`` checks on the
CPU that every anchor is in the source once).

B3 (``decode_attention.cu``): ``empty`` returns at once, ``no_splits`` skips every split's
work, ``no_merge`` skips the merge, ``no_load`` reads no cache row (zeros
in place of them). B4 (``flash_attention.cu``): ``no_merge`` skips the
merge of the key-split warps, ``no_compute`` the MMAs and softmax,
``no_load`` every ``cp.async``. B1 and B2 (``mips_tc.cuh``, their shared
scan): ``empty`` returns at once, ``no_mma`` skips the MMAs, ``no_load``
every 16-byte ``cp.async``, ``no_topk`` the scoring and top-k of each pass.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "breakdown"

B3_SWITCHES = {
    "empty": ("  const int h = blockIdx.y / ng, g0 = blockIdx.y % ng * GM,",
              "  if (a.D > 0) return;\n"
              "  const int h = blockIdx.y / ng, g0 = blockIdx.y % ng * GM,"),
    "no_splits": ("    split_partial<KV, GM, CPL>(a, b, h, G, t0, n,",
                  "    if (a.D < 0) split_partial<KV, GM, CPL>(a, b, h, G, t0, "
                  "n,"),
    "no_merge": ("  merge(a, a.o + row0, G,",
                 "  if (a.D < 0) merge(a, a.o + row0, G,"),
    "no_load": ("      out[u] = __ldg(reinterpret_cast<const uint4*>"
                "(p + i * row_bytes));",
                "      out[u] = make_uint4(i, 0u, 0u, 0u);"),
}
B4_SWITCHES = {
    "no_merge": ("  // the 4 warps (wk = 4: one row group) merge their partials",
                 "  if (a.D > 0) return;\n"
                 "  // the 4 warps (wk = 4: one row group) merge their partials"),
    "no_compute": ("    if (wactive && kmax >= 0) {",
                   "    if (wactive && kmax >= 0 && a.D < 0) {"),
    "no_load": ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, '
                '%2;\\n" ::"r"(d),',
                '  asm volatile("" ::"r"(d),'),
}
# B1 and B2 share their scan (mips_tc.cuh), so one set of switches serves
# both: each copy of the header is compiled with mips_topk.cu and with
# mips_topk_int8.cu
MIPS_SWITCHES = {
    "empty": ("  const int tile = blockIdx.x;\n",
              "  if (p.D > 0) return;\n  const int tile = blockIdx.x;\n"),
    "no_mma": ("    if (nmt > 0)\n", "    if (nmt > 0 && p.D < 0)\n"),
    "no_load": ("    cp_async<16>(dst, nbytes ? src : base, nbytes);",
                '    asm volatile("" ::"r"(nbytes));'),
    "no_topk": ("    if (ch != nch - 1) continue;",
                "    if (ch != nch - 1 || p.D > 0) continue;"),
}
B3_ROWS = ["base", "no_merge", "no_load", "no_splits", "empty"]
B4_ROWS = ["base", "no_merge", "no_compute+no_merge",
           "no_load+no_compute+no_merge"]
MIPS_ROWS = ["base", "no_topk", "no_mma+no_topk", "no_load+no_mma+no_topk",
             "empty"]


def patched(src: str, switches: dict, row: str) -> str:
    for name in row.split("+"):
        if name == "base":
            continue
        old, new = switches[name]
        if src.count(old) != 1:
            raise SystemExit(f"anchor of {name!r} not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build(ops, target: str, switches: dict, rows, argtypes, symbol: str,
          patch: str = None):
    """One library per row, all nvcc processes started together: the
    sources of ``csrc`` copied into a directory of the row's own, with
    ``patch`` (default: ``target``) switched, and ``target`` compiled."""
    patch = patch or target
    procs = {}
    for row in rows:
        d = OUT / f"{Path(target).stem}_{row.replace('+', '_')}"
        d.mkdir(parents=True, exist_ok=True)
        for f in CSRC.iterdir():
            text = f.read_text()
            (d / f.name).write_text(patched(text, switches, row)
                                    if f.name == patch else text)
        lib = d / f"lib{symbol}.so"
        procs[row] = (subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib), str(d / target)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for row, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {target} {row}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[row] = cdll
    return libs


def device_ms(torch, fn, name, iters=200):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if name in e.key)
    return us / iters / 1e3


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_breakdown.py runs only on a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mips_topk as mt
    from repro_torch.kernels import mips_topk_int8 as mt8
    from repro_torch.kernels import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; device ms per call, profiler")
    b3 = build(ops, "decode_attention.cu", B3_SWITCHES, B3_ROWS,
               da.ARGTYPES, "decode_attention")
    b4 = build(ops, "flash_attention.cu", B4_SWITCHES, B4_ROWS, fa.ARGTYPES,
               "flash_attention")
    b1 = build(ops, "mips_topk.cu", MIPS_SWITCHES, MIPS_ROWS, mt.ARGTYPES,
               "mips_topk", "mips_tc.cuh")
    b2 = build(ops, "mips_topk_int8.cu", MIPS_SWITCHES, MIPS_ROWS,
               mt8.ARGTYPES, "mips_topk_int8", "mips_tc.cuh")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # the paper's store at the serving shape: Q 32, 150,000 x 384, k 1,
    # tile 512; the store is larger than L2, so no flush between calls
    Q, N, D = 32, 150000, 384
    q = torch.randn((Q, D), generator=g, device=dev)
    for dt in (torch.float16, torch.float32):
        x = torch.randn((N, D), generator=g, device=dev).to(dt)
        cells = [f"{row} {device_ms(torch, lambda lib=lib: mt.mips_topk_tiles_cuda(lib, q, x, 1, 512), 'mips_tc_kernel', 50):.4f}"
                 for row, lib in b1.items()]
        print(f"B1 Q={Q} N={N} D={D} k=1 tile 512 {dt}: " + " | ".join(cells))
    del x
    q8, x8 = (torch.randint(-127, 128, (n, D), generator=g, device=dev,
                            dtype=torch.int8) for n in (Q, N))
    qs, xs = (torch.rand((n,), generator=g, device=dev) for n in (Q, N))
    cells = [f"{row} {device_ms(torch, lambda lib=lib: mt8.mips_topk_int8_tiles_cuda(lib, q8, qs, x8, xs, 1, 512), 'mips_tc_kernel', 50):.4f}"
             for row, lib in b2.items()]
    print(f"B2 Q={Q} N={N} D={D} k=1 tile 512 int8: " + " | ".join(cells))

    T, Hq, Hkv, D, ns = 160, 16, 8, 128, 8
    for B in (4, 1):
        q = torch.randn((B, Hq, D), generator=g, device=dev)
        k, v = (torch.randn((B, T, Hkv, D), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        for length in (100, 50):
            lens = torch.full((B,), length, dtype=torch.int32, device=dev)
            cells = [f"{row} {device_ms(torch, lambda lib=lib: da.decode_attention_cuda(lib, q, k, v, lens, ns), 'decode_attention_kernel'):.4f}"
                     for row, lib in b3.items()]
            print(f"B3 B={B} T={T} 16/8 heads D={D} bf16 cache, lengths "
                  f"{length}, {ns} splits: " + " | ".join(cells))

    for shape, causal, label in (((256, 64, 64, 6, 6, 64), False, "(a)"),
                                 ((1, 160, 160, 16, 8, 128), True, "(b) 160"),
                                 ((1, 46, 46, 16, 8, 128), True, "(b) 46")):
        B, S, Tk, H, Hk, Dh = shape
        q = torch.randn((B, S, H, Dh), generator=g, device=dev)
        k, v = (torch.randn((B, Tk, Hk, Dh), generator=g, device=dev)
                for _ in range(2))
        cells = [f"{row} {device_ms(torch, lambda lib=lib: fa.flash_attention_cuda(lib, q, k, v, causal), 'flash_attention_kernel'):.4f}"
                 for row, lib in b4.items()]
        print(f"B4 {label} {shape} f32 {'causal' if causal else 'non-causal'}"
              ": " + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
