"""Where a port attention kernel's time goes, on one NVIDIA GPU: times the
kernel as built from ``src/repro_torch/csrc`` beside copies of its source
with one part switched off, at the shapes the serving path gives it.

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
``no_load`` every ``cp.async``.
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
    "no_splits": ("    split_partial<KV, GM>(a, b, h, G, t0, n,",
                  "    if (a.D < 0) split_partial<KV, GM>(a, b, h, G, t0, n,"),
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
B3_ROWS = ["base", "no_merge", "no_load", "no_splits", "empty"]
B4_ROWS = ["base", "no_merge", "no_compute+no_merge",
           "no_load+no_compute+no_merge"]


def patched(src: str, switches: dict, row: str) -> str:
    for name in row.split("+"):
        if name == "base":
            continue
        old, new = switches[name]
        if src.count(old) != 1:
            raise SystemExit(f"anchor of {name!r} not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build(ops, stem: str, source: str, switches: dict, rows, argtypes,
          symbol: str):
    """One library per row, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for row in rows:
        tag = row.replace("+", "_")
        cu = OUT / f"{stem}_{tag}.cu"
        cu.write_text(patched(source, switches, row))
        lib = OUT / f"lib{stem}_{tag}.so"
        procs[row] = (subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for row, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {stem} {row}:\n{log}")
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
    from repro_torch.kernels import ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; device ms per call, profiler")
    b3 = build(ops, "decode_attention",
               (CSRC / "decode_attention.cu").read_text(), B3_SWITCHES,
               B3_ROWS, da.ARGTYPES, "decode_attention")
    b4 = build(ops, "flash_attention",
               (CSRC / "flash_attention.cu").read_text(), B4_SWITCHES,
               B4_ROWS, fa.ARGTYPES, "flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

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
