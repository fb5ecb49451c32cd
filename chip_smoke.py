#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure exits non-zero and the
result line is printed only when every phase passed:

1. device — refuses to run without CUDA (there is no CPU fallback), prints
   the card and its power limit;
2. build — compiles every kernel from ``src/repro_torch/csrc`` with nvcc
   for sm_90a (in parallel) and prints each one's registers, shared
   memory and spills;
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving shapes plus ragged (bf16, f32, head dims 192 and 256)
   cases and the LM engine's (phase 7: B3 over a 512-row f32 cache with
   lengths past it, B4 prefill at S = T = 512), timed from the profiler (median, min and max of three runs; a
   kernel the trace does not name fails the run) and with CUDA events
   beside the plain version and a one-call PyTorch yardstick; the two
   search kernels' launch configuration and ptxas report; B3 as
   ``gqa_decode`` calls it (one launch: the splits and their merge);
4. slice, fp16 store — writes the paper's 150,000-pair store, opens it
   with ``StorInfer.open`` (flat index, qwen3-1.7b at full width, random
   weights from ``--seed``) and serves a mixed stream through
   ``query_batch`` and ``serve()``/``submit()``, with a §3.1 write-back
   and delta rebuild (prefill on B4, decode on B3);
5. slice, int8 store — the same stream over an int8 store;
6. slice minilm — the reference's default configuration at paper size:
   the store written with the port's MiniLM encoder (random weights from
   ``--seed``), opened with ``embedder="minilm"`` and the default
   ``index="auto"``, which picks the IVF tier at 150,000 rows, fits it and
   persists the fit; a second open loads the fit. Hits, then the stream,
   are served with MiniLM query encoding on B4 (non-causal) and misses
   prefilled on B4 (causal) and decoded on B3;
7. build — the offline precompute through ``StorInfer.build``: (a) the
   LLM-driven build, ``TorchLM`` on qwen3-1.7b at full width (phase 4's
   weights, a 512-token engine: prompts prefilled on B4, queries sampled
   and answers decoded on B3); (b) the reference launcher's default build
   (oracle LM, hash embedder, 8,192 pairs over 200 docs) with the dedup
   index crossing into IVF on the card, opened and queried on B1; (c) an
   int8 build killed halfway and resumed, byte-identical to an
   uninterrupted one, queried on B2; (d) the same hash build with the
   dedup index on the card and on the CPU, byte-identical; (e) a MiniLM
   build (the encoder on B4, non-causal).

The kernels' launch counters are set to 0 just before each serving run
and each build and read just after it: every kernel of the path must have
run there. The
last lines are one JSON line of per-kernel numbers, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12            # CUDA cores, the f32 FMAs of B3
# tensor cores: a B1 product is two TF32 products with a 16-bit store
# (2xTF32), three with an f32 store, as is a B4 f32 product (3xTF32)
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12           # int8 rate, B2's int8 products
TOL_F32 = 1e-5               # B1 contract (rtol and atol)
TOL_DECODE_F32 = 2e-4        # B3 contract with an f32 cache
# B3 with a bf16 cache: the kernel rounds the unnormalised exp(s - m_split)
# to bf16 before P.V, the plain version the normalised probability, so a
# term may differ by one bf16 ulp of p (2^-8 relative); 1e-2 absolute on
# outputs of unit-scale values.
TOL_DECODE_BF16 = 1e-2
TOL_FLASH_F32 = 2e-4         # B4 contract, f32 inputs
TOL_FLASH_BF16 = 5e-2        # B4 contract, bf16 inputs
MAX_NEW = 16
N_STORE = 150000             # the paper's store size (pairs)
# The minilm slice's hit threshold. With random weights the sinusoidal
# position table dominates MiniLM's pooled vector, so every pair of texts
# scores close to 1 (seed 0 on an NVIDIA H100 80GB HBM3, 700.00 W: the
# unanticipated phrasings' top-1 0.9926-0.9961, the "hi, " prefixed stored
# queries 0.99978 and up, exact ones 0.99998 and up). 0.999 sits between
# the two groups, so the unanticipated phrasings miss and the stored ones
# hit.
S_TH_MINILM = 0.999
# phase 7: the paper's generation time on an H100 (s per pair) and sizes
PAPER_S_PER_PAIR = 0.3
N_BUILD_LLM = 8              # 7a: pairs generated by the LLM
N_BUILD = 8192               # 7b: the launcher's default build, cut
N_BUILD_RESUME = 1024        # 7c
N_BUILD_DEVICE = 2048        # 7d
N_BUILD_MINILM = 512         # 7e
# A build dedups on its device (a torch f32 product of the index's shape at
# that wave); the invariant is checked afterwards with one product over all
# rows, which sums in another order: the two may differ by a few ulps of
# f32 at |s| <= 1.
TOL_SIM_ORDER = 1e-6


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def pct(a, q):
    import numpy as np
    return float(np.percentile(np.asarray(a, np.float64) * 1e3, q)) \
        if len(a) else float("nan")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters, flush=None):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events
    around each call, after warm-up; ``flush`` is written between calls
    so a large operand is not found in L2)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        if flush is not None:
            flush.add_(1)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in ev)
    return t[len(t) // 2]


def _profiled_us(torch, fn, iters, kernel=None):
    """Summed device time (us) of the device activities ``fn`` issues over
    ``iters`` calls, from a torch.profiler trace (CUPTI); only the kernel
    whose name contains ``kernel`` when one is given."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if kernel is not None and kernel not in e.key:
            continue
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total


def device_ms(torch, fn, iters, flush=None, kernel=None):
    """Device time per call (ms) from the profiler: the named kernel's
    time, or every device activity of the call minus the L2 flush's
    (profiled alone). A trace with no device time for the call, or no
    activity whose name holds ``kernel``, fails the run: a renamed kernel
    must not be timed as something else."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    step = fn if flush is None else (lambda: (flush.add_(1), fn()))
    tot = _profiled_us(torch, step, iters, kernel)
    if flush is not None and kernel is None:
        tot -= _profiled_us(torch, lambda: flush.add_(1), iters)
    check(tot > 0, "the profiler saw no device time" +
          (f" in a kernel named like {kernel!r}" if kernel else ""))
    return tot / iters / 1e3


def timed(torch, fn, iters, flush=None, kernel=None, reps=3):
    """((min, median, max) device ms per call over ``reps`` profiled runs
    of ``iters`` calls each, from the profiler; the event time per call,
    host gaps included)."""
    call = time_ms(torch, fn, iters, flush)
    devs = sorted(device_ms(torch, fn, iters, flush, kernel)
                  for _ in range(reps))
    return (devs[0], devs[len(devs) // 2], devs[-1]), call


def spread(t):
    """'median (min-max)' of a timed() triple, in ms."""
    return f"{t[1]:.4f} ({t[0]:.4f}-{t[2]:.4f})"


def bound(nbytes, ops, peak):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def unit_rows(torch, g, n, d, dev):
    x = torch.randn((n, d), generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def check_mips(torch, ops, ref, q, x, k, tile, label):
    """The wrapper the index calls (kernel, tile clamp, combine) vs the
    plain full scan: values within 1e-5, ids equal except on ties."""
    v, i = ops.mips_topk(q, x, k, tile)
    vp, ip = ref.mips_topk_ref(q, x, k)
    torch.cuda.synchronize()
    err = float((v - vp).abs().max())
    check(torch.allclose(v, vp, rtol=TOL_F32, atol=TOL_F32),
          f"B1 {label}: values differ from plain by {err}")
    s = q @ x.float().T
    diff = i != ip
    if diff.any():
        a = torch.gather(s, 1, i.long())[diff]
        b = torch.gather(s, 1, ip.long())[diff]
        check(torch.allclose(a, b, rtol=TOL_F32, atol=TOL_F32),
              f"B1 {label}: ids differ from plain off a tie")
    print(f"B1 {label}: ok max_abs_err={err:.3e} "
          f"id_mismatches_on_ties={int(diff.sum())}")
    return err


def launch_report(label, cfg, log, *needles):
    """Print the launch configuration of the instance a search kernel runs
    at the serving shape (the runtime's figures) and ptxas' report of it
    (the lines after the entry whose mangled name holds every needle)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = cfg["grid_x"] * cfg["grid_y"]
    print(f"{label} launch: grid {cfg['grid_x']} x {cfg['grid_y']} = "
          f"{blocks} blocks of {cfg['threads']} threads, "
          f"{cfg['blocks_per_sm']} blocks per SM on {sms} SMs "
          f"({blocks / (cfg['blocks_per_sm'] * sms):.2f} waves), "
          f"{cfg['registers']} registers, {cfg['local_bytes']} local bytes "
          f"per thread, {cfg['smem_bytes']} B dynamic shared memory")
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry" in line and all(w in line for w in needles):
            for rest in lines[n + 1:n + 4]:
                if "Compiling entry" in rest:
                    break
                print(f"{label} ptxas: {rest.strip()}")
            return
    raise SmokeFailure(f"{label}: no ptxas report for an entry named like "
                       f"{needles}")


def phase_kernels(torch, np, args, dev, prompt_len, logs):
    from repro_torch.core.store import quantize_rows
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mips_topk as mt
    from repro_torch.kernels import mips_topk_int8 as mt8
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.zeros(64 * 2 ** 20 // 4 * 2, device=dev)   # 128 MB > L2
    Q, D, N, k, tile = 32, 384, N_STORE, 1, 512
    rows = []

    # -- B1 ------------------------------------------------------------------
    q = unit_rows(torch, g, Q, D, dev)
    x = unit_rows(torch, g, N, D, dev).half()
    err = check_mips(torch, ops, ref, q, x, k, tile, f"main Q={Q} N={N} fp16")
    for dt in (torch.bfloat16, torch.float32):
        check_mips(torch, ops, ref, q, unit_rows(torch, g, N, D, dev).to(dt),
                   k, tile, f"main Q={Q} N={N} {dt}")
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for qn in (5, 1, 33):
            check_mips(torch, ops, ref, unit_rows(torch, g, qn, 100, dev),
                       unit_rows(torch, g, 1000, 100, dev).to(dt), 7, 512,
                       f"ragged Q={qn} N=1000 D=100 k=7 {dt}")
    qi = torch.randint(-2, 3, (5, 24), generator=g, device=dev).float()
    xi = torch.randint(-2, 3, (700, 24), generator=g, device=dev).float()
    xi[::5] = xi[0]
    for kk, tt in ((1, 128), (7, 128), (40, 256), (64, 64)):
        a = ops.mips_topk(qi, xi, kk, tt)
        b = ref.mips_topk_ref(qi, xi, kk)      # integer scores: exact
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"B1 forced ties k={kk}: not bitwise equal to plain")
    print("B1 forced ties: bitwise equal to plain (k=1,7,40,64)")
    tn = ops._clamp_tile(N, k, tile)
    launch_report("B1", mt.launch_config(ops._lib("mips_topk"), x.dtype, Q, D,
                                         N, k, tn),
                  logs["mips_topk"], "Store16I6__half", "Li4ELb1E")
    ms, call = timed(torch, lambda: mt.mips_topk_tiles_cuda(
        ops._lib("mips_topk"), q, x, k, tn), 50, flush, "mips_tc_kernel")
    plain, plain_call = timed(
        torch, lambda: mt.mips_topk_tiles_plain(q, x, k, tn), 10, flush)
    # the library call on the same inputs upcasts the fp16 store to f32 on
    # every call (no f32 x f16 matmul); the GEMM + top-k alone, on a store
    # upcast beforehand, is timed beside it
    lib, lib_call = timed(torch, lambda: torch.topk(q @ x.t().float(), k),
                          10, flush)
    x32 = x.float()
    lib_gemm, _ = timed(torch, lambda: torch.topk(q @ x32.t(), k), 10, flush)
    del x32
    print(f"B1 library yardstick: matmul + topk with the f32 upcast "
          f"{spread(lib)} ms, on a store upcast beforehand "
          f"{spread(lib_gemm)} ms (device time per call)")
    nt = -(-N // tn)
    # two TF32 products per product of an fp16 store (2xTF32)
    b_ms, b_by = bound(nb(q, x) + nt * Q * k * 8, 2 * 2 * Q * N * D,
                       TF32_FLOPS)
    old_ms, old_by = bound(nb(q, x) + nt * Q * k * 8, 2 * Q * N * D,
                           F32_FLOPS)
    print(f"B1 bound: {b_ms:.4f} ms ({b_by}; 2xTF32 products at the TF32 "
          f"rate); on PR 8's basis, f32 products on the CUDA cores: "
          f"{old_ms:.4f} ms ({old_by})")
    rows.append(dict(name="mips_topk", route="cuda",
                     source="src/repro_torch/csrc/mips_topk.cu",
                     replaces="src/repro/kernels/mips_topk.py:148",
                     max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     calls=(call, plain_call, lib_call)))

    # -- B2 ------------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    qh = rng.standard_normal((Q, D), dtype=np.float32)
    xh = rng.standard_normal((N, D), dtype=np.float32)
    (q8, qs), (x8, xs) = quantize_rows(qh), quantize_rows(xh)
    q8, qs, x8, xs = (torch.from_numpy(a).to(dev) for a in (q8, qs, x8, xs))

    def b2_pair(a, b, c, d, kk, tt):
        """The wrapper the index calls vs the plain full scan."""
        got = ops.mips_topk_int8(a, b, c, d, kk, tt)
        want = ref.topk_by_value(mt8.int8_scores_plain(a, b, c, d), kk)
        torch.cuda.synchronize()
        return got, want

    (v, i), (vp, ip) = b2_pair(q8, qs, x8, xs, k, tile)
    check(torch.equal(v, vp) and torch.equal(i, ip),
          "B2 main: not bit-for-bit equal to plain")
    print(f"B2 main Q={Q} N={N}: bit-for-bit equal to plain")
    err8 = float((v - vp).abs().max())
    (r8, rs), (y8, ys) = (quantize_rows(rng.standard_normal((5, 100),
                                                            dtype=np.float32)),
                          quantize_rows(rng.standard_normal((1000, 100),
                                                            dtype=np.float32)))
    (v, i), (vp, ip) = b2_pair(*(torch.from_numpy(a).to(dev)
                                 for a in (r8, rs, y8, ys)), 7, 512)
    check(torch.equal(v, vp) and torch.equal(i, ip),
          "B2 ragged: not bit-for-bit equal to plain")
    print("B2 ragged N=1000 D=100 k=7: bit-for-bit equal to plain")
    for qn, dd in ((1, 99), (33, 100), (9, 24)):
        (r8, rs), (y8, ys) = (quantize_rows(rng.standard_normal(
            (n, dd), dtype=np.float32)) for n in (qn, 1000))
        (v, i), (vp, ip) = b2_pair(*(torch.from_numpy(a).to(dev)
                                     for a in (r8, rs, y8, ys)), 7, 512)
        check(torch.equal(v, vp) and torch.equal(i, ip),
              f"B2 ragged Q={qn} D={dd}: not bit-for-bit equal to plain")
    print("B2 ragged Q=1 D=99, Q=33 D=100, Q=9 D=24: bit-for-bit equal to "
          "plain")
    launch_report("B2", mt8.launch_config(ops._lib("mips_topk_int8"), Q, D,
                                          N, k, tn),
                  logs["mips_topk_int8"], "StoreS8", "Li4ELb1E")
    ms, call = timed(torch, lambda: mt8.mips_topk_int8_tiles_cuda(
        ops._lib("mips_topk_int8"), q8, qs, x8, xs, k, tn), 50, flush,
        "mips_tc_kernel")
    plain, plain_call = timed(torch, lambda: mt8.mips_topk_int8_tiles_plain(
        q8, qs, x8, xs, k, tn), 10, flush)
    lib, lib_call = timed(torch, lambda: torch.topk(
        (q8.float() @ x8.t().float()) * qs[:, None] * xs[None, :], k), 10,
        flush)
    b_ms, b_by = bound(nb(q8, qs, x8, xs) + nt * Q * k * 8, 2 * Q * N * D,
                       INT8_OPS)
    rows.append(dict(name="mips_topk_int8", route="cuda",
                     source="src/repro_torch/csrc/mips_topk_int8.cu",
                     replaces="src/repro/kernels/mips_topk_int8.py:50",
                     max_abs_err=err8, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     calls=(call, plain_call, lib_call)))

    # -- B3 ------------------------------------------------------------------
    B, T, Hq, Hkv, Dh, ns = 4, 160, 16, 8, 128, 8

    def b3_case(T_, lengths, dt, ns_, tol, label, D_=Dh):
        qq = torch.randn((B, Hq, D_), generator=g, device=dev)
        kk = torch.randn((B, T_, Hkv, D_), generator=g, device=dev).to(dt)
        vv = torch.randn((B, T_, Hkv, D_), generator=g, device=dev).to(dt)
        # the one launch gqa_decode makes (the splits and their merge)
        # against the plain split version and the naive math
        got = ops.decode_attention(qq, kk, vv, lengths, ns_)
        split = da.combine_splits(*da.decode_partials_plain(
            qq, kk, vv, lengths, ns_))
        want = da.decode_attention_plain(qq, kk, vv, lengths)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(torch.allclose(got, split, rtol=tol, atol=tol)
              and torch.allclose(got, want, rtol=tol, atol=tol),
              f"B3 {label}: differs from plain (max {e})")
        print(f"B3 {label}: ok max_abs_err={e:.3e} vs the naive math, "
              f"{float((got - split).abs().max()):.3e} vs the plain split "
              f"version (tol {tol})")
        return e, (qq, kk, vv)

    main_len = torch.full((B,), 100, dtype=torch.int32, device=dev)
    err3, (qq, kk, vv) = b3_case(T, main_len, torch.bfloat16, ns,
                                 TOL_DECODE_BF16, "main bf16 cache")
    b3_case(T, main_len, torch.float32, ns, TOL_DECODE_F32, "main f32 cache")
    rag = torch.randint(0, 157, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    b3_case(157, rag, torch.bfloat16, ns, TOL_DECODE_BF16,
            "ragged T=157 bf16")
    b3_case(157, rag, torch.float32, 3, TOL_DECODE_F32, "ragged T=157 f32")
    for Dw in (192, 256):   # deepseek-v2-lite's heads, and the widest D
        b3_case(T, main_len, torch.float32, ns, TOL_DECODE_F32,
                f"wide D={Dw} f32 cache", Dw)
        b3_case(157, rag, torch.bfloat16, ns, TOL_DECODE_BF16,
                f"wide D={Dw} ragged T=157 bf16 cache", Dw)
    # the LM engine's session (TorchLM in phase 7): B 1, an f32 cache of
    # T = 512, lengths up to and past T - 1 (a decode past max_len passes
    # lengths of T and more; the kernel clamps them to T - 1)
    errs = []
    for L in (300, 511, 512, 700):
        lm_len = torch.full((1,), L, dtype=torch.int32, device=dev)
        q1 = torch.randn((1, Hq, Dh), generator=g, device=dev)
        k1, v1 = (torch.randn((1, 512, Hkv, Dh), generator=g, device=dev)
                  for _ in range(2))
        got = ops.decode_attention(q1, k1, v1, lm_len, ns)
        want = da.decode_attention_plain(q1, k1, v1, lm_len.clamp(max=511))
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=TOL_DECODE_F32,
                             atol=TOL_DECODE_F32),
              f"B3 LM engine T=512 length {L}: differs from plain "
              f"({errs[-1]})")
    len300 = torch.full((1,), 300, dtype=torch.int32, device=dev)
    lm_ms, lm_call = timed(torch, lambda: ops.decode_attention(
        q1, k1, v1, len300, ns), 200, None, "decode_attention_kernel")
    print(f"B3 LM engine (B 1, f32 cache T=512, lengths 300/511/512/700): ok "
          f"max_abs_err={max(errs):.3e} (tol {TOL_DECODE_F32}); length 300: "
          f"device {spread(lm_ms)} ms, per call with host gaps "
          f"{lm_call:.4f} ms")
    ms, call = timed(torch, lambda: ops.decode_attention(
        qq, kk, vv, main_len, ns), 200, None, "decode_attention_kernel")
    plain, plain_call = timed(torch, lambda: da.combine_splits(
        *da.decode_partials_plain(qq, kk, vv, main_len, ns)), 50)
    pos = torch.arange(T, device=dev)
    mask = (pos[None, :] <= main_len[:, None])[:, None, None, :]
    qs_ = qq.to(kk.dtype)[:, :, None, :]
    kt, vt = kk.transpose(1, 2), vv.transpose(1, 2)
    lib, lib_call = timed(torch, lambda: F.scaled_dot_product_attention(
        qs_, kt, vt, attn_mask=mask, enable_gqa=True), 200)
    att = int((main_len.clamp(max=T - 1) + 1).sum())
    kv_bytes = att * Hkv * Dh * kk.element_size() * 2
    b_ms, b_by = bound(nb(qq, main_len) + kv_bytes + B * Hq * Dh * 4,
                       4 * att * Hq * Dh, F32_FLOPS)
    print(f"B3 as gqa_decode calls it (ops.decode_attention, one launch): "
          f"device {spread(ms)} ms, per call with host gaps {call:.4f} ms")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention.py:47",
                     max_abs_err=err3, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     calls=(call, plain_call, lib_call)))
    # -- B4 ------------------------------------------------------------------
    from repro_torch.kernels import flash_attention as fa
    lib_fa = ops._lib("flash_attention")

    def b4_case(shape, causal, dt, label):
        B_, S_, T_, Hq_, Hkv_, D_ = shape
        qq, kk, vv = (torch.randn(sh, generator=g, device=dev).to(dt)
                      for sh in ((B_, S_, Hq_, D_), (B_, T_, Hkv_, D_),
                                 (B_, T_, Hkv_, D_)))
        got = ops.flash_attention(qq, kk, vv, causal)
        want = fa.flash_attention_plain(qq, kk, vv, causal)
        torch.cuda.synchronize()
        tol = TOL_FLASH_F32 if dt == torch.float32 else TOL_FLASH_BF16
        e = float((got.float() - want.float()).abs().max())
        check(got.dtype == dt and torch.allclose(got.float(), want.float(),
                                                 rtol=tol, atol=tol),
              f"B4 {label}: differs from plain (max {e})")
        print(f"B4 {label}: ok max_abs_err={e:.3e} (tol {tol})")
        return e, (qq, kk, vv)

    def b4_timing(qq, kk, vv, causal, iters, flush_=None):
        """(kernel, plain, library) device ms, their per-call event ms,
        and the bound, for one shape."""
        B_, S_, Hq_, D_ = qq.shape
        T_ = kk.shape[1]
        ms_, call_ = timed(torch, lambda: fa.flash_attention_cuda(
            lib_fa, qq, kk, vv, causal), iters, flush_,
            "flash_attention_kernel")
        plain_, plain_call_ = timed(torch, lambda: fa.flash_attention_plain(
            qq, kk, vv, causal), max(iters // 5, 10), flush_)
        qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
        lib_, lib_call_ = timed(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters, flush_)
        # the (query, key) pairs this call must score: all, or the causal
        # lower triangle
        pairs = sum(min(i + 1, T_) for i in range(S_)) if causal \
            else S_ * T_
        ops_ = 4 * B_ * Hq_ * D_ * pairs
        b_ms_, b_by_ = bound(2 * nb(qq) + nb(kk, vv), 3 * ops_, TF32_FLOPS) \
            if qq.dtype == torch.float32 else \
            bound(2 * nb(qq) + nb(kk, vv), ops_, BF16_FLOPS)
        return ms_, plain_, lib_, (call_, plain_call_, lib_call_), b_ms_, \
            b_by_

    enc_shape = (256, 64, 64, 6, 6, 64)         # MiniLM, one 256-row bucket
    pre_shape = (1, 160, 160, 16, 8, 128)       # qwen3-1.7b prefill, max_len
    real = (1, prompt_len, prompt_len, 16, 8, 128)
    err4, enc_in = b4_case(enc_shape, False, torch.float32,
                           "(a) MiniLM encode B=256 S=T=64 H=6 D=64 f32")
    _, pre_in = b4_case(pre_shape, True, torch.float32,
                        "(b) prefill S=T=160 Hq=16 Hkv=8 D=128 f32 causal")
    _, real_in = b4_case(real, True, torch.float32,
                         f"(b) prefill at a real prompt's S=T={prompt_len} "
                         "f32 causal")
    _, lm_in = b4_case((1, 512, 512, 16, 8, 128), True, torch.float32,
                       "(c) the LM engine's prefill at its max_len, S=T=512 "
                       "f32 causal")
    b4_case((3, 100, 100, 12, 4, 128), True, torch.float32,
            "ragged B=3 S=T=100 Hq=12 Hkv=4 D=128 f32 causal")
    b4_case((2, 70, 130, 6, 2, 96), False, torch.float32,
            "ragged B=2 S=70 T=130 Hq=6 Hkv=2 D=96 f32 non-causal")
    b4_case(pre_shape, True, torch.bfloat16,
            "(b) prefill S=T=160 bf16 causal")
    b4_case(enc_shape, False, torch.bfloat16, "(a) MiniLM encode bf16")
    b4_case((3, 100, 100, 12, 4, 128), True, torch.bfloat16,
            "ragged S=T=100 G=3 bf16 causal")
    for Dw in (192, 256):
        b4_case((1, 160, 160, 16, 8, Dw), True, torch.float32,
                f"wide D={Dw} prefill S=T=160 f32 causal")
        b4_case((2, 70, 130, 6, 2, Dw), False, torch.bfloat16,
                f"wide D={Dw} S=70 T=130 bf16 non-causal")
    ms, plain, lib, calls, b_ms, b_by = b4_timing(*enc_in, False, 50, flush)
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:65",
                     max_abs_err=err4, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib, calls=calls,
                     shape="(a) B=256 S=T=64 H=6 D=64 f32 non-causal"))
    for label, (qq, kk, vv) in (("(b) S=T=160", pre_in),
                                (f"(b) S=T={prompt_len}", real_in),
                                ("(c) S=T=512", lm_in)):
        t = b4_timing(qq, kk, vv, True, 200)
        print(f"timing flash_attention {label} f32 causal (device time per "
              f"call, profiler, median (min-max) of 3): kernel "
              f"{spread(t[0])} ms, plain {spread(t[1])} ms, library "
              f"{spread(t[2])} ms, bound {t[4]:.5f} ms ({t[5]}); per call "
              f"with host gaps (CUDA events): kernel {t[3][0]:.4f}, plain "
              f"{t[3][1]:.4f}, library {t[3][2]:.4f} ms")
    for r in rows:
        c = r["calls"]
        print(f"timing {r['name']} {r.get('shape', '')} (device time per "
              "call, profiler, median (min-max) of 3): kernel "
              f"{spread(r['ms'])} ms, plain {spread(r['plain_ms'])} ms, "
              f"library {spread(r['library_ms'])} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); per call with "
              f"host gaps (CUDA events): kernel {c[0]:.4f}, plain "
              f"{c[1]:.4f}, library {c[2]:.4f} ms")
        for key in ("ms", "plain_ms", "library_ms"):
            r[key] = r[key][1]
    del flush
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the serving slice
# ---------------------------------------------------------------------------


def make_stream(kb, pairs, seed):
    """~64 unique queries: 16 exact stored queries, 16 near ones (a filler
    prefix), 32 unanticipated phrasings (the miss mass)."""
    import numpy as np
    from repro_torch.core.kb import HARD_TEMPLATES
    rng = np.random.default_rng(seed + 17)
    picks = rng.choice(len(pairs), 32, replace=False)
    exact = [pairs[i][0] for i in picks[:16]]
    near = ["hi, " + pairs[i][0] for i in picks[16:]]
    facts = rng.choice(len(kb.facts), 32, replace=False)
    hard = [HARD_TEMPLATES[j % len(HARD_TEMPLATES)].format(
        r=kb.facts[f].relation, e=kb.facts[f].entity)
        for j, f in enumerate(facts)]
    stream = list(dict.fromkeys(exact + near + hard))
    order = rng.permutation(len(stream))
    return [stream[i] for i in order], set(exact)


def serve_slice(torch, np, si, stream, exact, answers, label,
                serve_first=False):
    """query_batch over one half of the stream, serve()/submit() over the
    other (the first half goes to query_batch, unless ``serve_first``);
    checks every result and returns the per-query (hit, row text), the
    launch counts, the latency numbers and the results in stream order."""
    from repro_torch.kernels import ops
    index0 = si._batched.index
    rows0 = len(index0)
    # the flat tier appends deltas to its device copy; IVF refits
    up0 = index0.dev.uploads if hasattr(index0, "dev") else None
    half = len(stream) // 2
    qb_texts, sv_texts = (stream[half:], stream[:half]) if serve_first \
        else (stream[:half], stream[half:])
    ops.reset_launch_counts()

    def run_query_batch():
        t0 = time.perf_counter()
        got = si.query_batch(qb_texts, max_new=MAX_NEW)
        return got, time.perf_counter() - t0

    def run_serve():
        with si.serve():
            futs = [si.submit(t, max_new=MAX_NEW) for t in sv_texts]
            return [f.result(timeout=600) for f in futs]

    if serve_first:
        served = run_serve()
        qb, t_qb = run_query_batch()
        res = served + qb
    else:
        qb, t_qb = run_query_batch()
        served = run_serve()
        res = qb + served
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"{label}: launches on the main path {counts}")
    # the stored pairs: the store's own, plus the §3.1 write-backs
    answers = dict(answers)
    answers.update((t, r.response) for t, r in zip(stream, res)
                   if not r.hit)
    for text, r in zip(stream, res):
        if r.hit:
            check(r.source == "store" and r.matched_query in answers
                  and r.response == answers[r.matched_query],
                  f"{label}: hit {text!r} returned a response that is not "
                  "the stored one")
        else:
            check(r.source == "llm" and 1 <= r.tokens <= MAX_NEW,
                  f"{label}: miss {text!r} decoded {r.tokens} tokens")
        if text in exact:
            check(r.hit and r.score >= 0.999,
                  f"{label}: exact stored query {text!r} missed")
    b = si._batched
    delta = b.index.dev.uploads - up0 if up0 is not None else None
    check(b.stats.index_rebuilds >= 1 and len(b.index) > rows0
          and (delta is None or delta > 0),
          f"{label}: no §3.1 write-back + rebuild (rebuilds="
          f"{b.stats.index_rebuilds}, rows {rows0}->{len(b.index)}, delta "
          f"uploads {delta})")
    hits = [r for r in res if r.hit]
    misses = [r for r in res if not r.hit]
    out = {
        "hits": len(hits), "misses": len(misses),
        "writebacks": b.stats.writebacks, "rebuilds": b.stats.index_rebuilds,
        "delta_uploads": delta,
        "query_batch_s": t_qb,
        "hit_p50_ms": pct([r.latency_s for r in served if r.hit], 50),
        "hit_p99_ms": pct([r.latency_s for r in served if r.hit], 99),
        "miss_p50_ms": pct([r.latency_s for r in served if not r.hit], 50),
        "miss_p99_ms": pct([r.latency_s for r in served if not r.hit], 99),
        "qb_hit_p50_ms": pct([r.latency_s for r in qb if r.hit], 50),
        "qb_hit_p99_ms": pct([r.latency_s for r in qb if r.hit], 99),
        "qb_miss_p50_ms": pct([r.latency_s for r in qb if not r.hit], 50),
        "qb_miss_p99_ms": pct([r.latency_s for r in qb if not r.hit], 99),
    }
    print(f"{label}: " + json.dumps(out))
    return [(r.hit, r.response if r.hit else None) for r in res], counts, \
        out, res


def decode_rate(torch, engine, prompt, batch):
    """Greedy decode of ``batch`` copies of one prompt (one wave):
    generated tokens per second and ms per decode step."""
    s = engine.start_batch_session([prompt] * batch, max_new=33)
    s.run()
    torch.cuda.synchronize()
    toks = sum(len(r.out_ids) - 1 for r in s.results())
    steps = s.chunks_run * engine.chunk
    return toks / s.decode_s, s.decode_s / steps * 1e3


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def decode_profile(torch, engine, prompt, batch):
    """One decode chunk (``engine.chunk`` steps at ``batch`` live slots)
    under torch.profiler: wall time, device busy time, the device
    activities that took the most time, and the host-side operators with
    the most self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    s = engine.start_batch_session([prompt] * batch,
                                   max_new=engine.chunk + 1)
    s.sched._admit()                 # prefill outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.step_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev = sorted((e for e in ev if _dev_us(e) > 0 and e.self_cpu_time_total
                  == 0), key=lambda e: -_dev_us(e))
    busy = sum(_dev_us(e) for e in dev) / 1e6
    top = [(e.key[:70], _dev_us(e) / 1e3, e.count) for e in dev[:6]]
    host = sorted(ev, key=lambda e: -e.self_cpu_time_total)
    cpu = [(e.key[:70], e.self_cpu_time_total / 1e3, e.count)
           for e in host[:8]]
    ops = sum(e.count for e in ev if e.key.startswith("aten::"))
    launches = sum(e.count for e in ev if e.key.startswith("cudaLaunchKernel"))
    return wall, busy, top, cpu, ops, launches


def make_corpus(seed):
    """The squad KB, its pairs, the tokenizer and the query stream."""
    from repro_torch.core.kb import build_kb
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.launch.serve import kb_pairs
    kb = build_kb("squad", n_docs=20)
    pairs = kb_pairs(kb)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=2048)
    stream, exact = make_stream(kb, pairs, seed)
    return kb, pairs, tok, stream, exact


def phase_slices(torch, np, args, card, corpus):
    from repro_torch.api import EngineCfg, StorInfer, SystemCfg
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.core.runtime import BatchedRuntimeCfg
    from repro_torch.launch.serve import write_kb_store

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    kb, pairs, tok, stream, exact = corpus
    answers = dict(pairs)
    emb = HashEmbedder()
    cfg = SystemCfg(index="flat", s_th_run=0.9, decode_slots=4,
                    batched=BatchedRuntimeCfg(add_misses=True,
                                              rebuild_every=8),
                    engine=EngineCfg(arch="qwen3-1.7b", smoke=False,
                                     max_len=160, chunk=8, seed=args.seed))
    results, counts_all = {}, {}
    engine = None
    for label, dtype in (("fp16", "float16"), ("int8", "int8")):
        t0 = time.perf_counter()
        write_kb_store(work / label, kb, emb, N_STORE, seed=args.seed,
                       emb_dtype=dtype).close()
        t_write = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        si = StorInfer.open(work / label, cfg, tokenizer=tok, engine=engine)
        torch.cuda.synchronize()
        t_open = time.perf_counter() - t0
        engine = si.engine
        with si:
            check(si.store.count == N_STORE
                  and len(si.index) == N_STORE,
                  f"{label}: store/index rows wrong")
            check(si.index.dev.layout == "kernel"
                  and si.index.dev.quantized == (dtype == "int8"),
                  f"{label}: index not on the kernel layout")
            print(f"slice {label}: store {N_STORE} pairs written in "
                  f"{t_write:.2f} s, opened (upload"
                  f"{' + engine init' if label == 'fp16' else ''}) in "
                  f"{t_open:.2f} s")
            res, counts, out, _ = serve_slice(torch, np, si, stream, exact,
                                              answers, f"slice {label}")
            results[label] = (res, out)
            counts_all[label] = counts
            need = ("mips_topk" if dtype == "float16" else "mips_topk_int8",
                    "decode_attention", "flash_attention")
            for n in need:
                check(counts[n] > 0, f"slice {label}: kernel {n} was not "
                      "launched on the main path")
            peak = torch.cuda.max_memory_allocated()
            print(f"slice {label}: peak device memory {peak / 2**30:.3f} GiB "
                  f"on {card}")
            out["peak_mem_gib"] = peak / 2 ** 30
    same = [a == b for a, b in zip(results["fp16"][0], results["int8"][0])]
    agree = sum(same) / len(same)
    check(agree >= 0.99, f"int8 hit rows agree with fp16 on only {agree:.3f}")
    print(f"slice int8 vs fp16: hit decisions and hit responses agree on "
          f"{agree:.3f} of {len(same)} queries")
    miss_prompt = stream[[i for i, (h, _) in
                          enumerate(results["fp16"][0]) if not h][0]]
    for bsz in (1, 4):
        tps, step_ms = decode_rate(torch, engine, miss_prompt, bsz)
        print(f"decode qwen3-1.7b full width fp32 weights, batch {bsz}: "
              f"{tps:.1f} tokens/s, {step_ms:.2f} ms/step on {card}")
    wall, busy, top, cpu, n_ops, n_launch = decode_profile(
        torch, engine, miss_prompt, 4)
    print(f"decode chunk profile (batch 4, {engine.chunk} steps, profiler "
          f"on): wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, "
          f"device idle share {1 - busy / wall:.3f}, {n_ops} aten ops, "
          f"{n_launch} cudaLaunchKernel calls")
    for name, ms, n in top:
        print(f"  device {ms:9.3f} ms  x{n:<5d} {name}")
    for name, ms, n in cpu:
        print(f"  host   {ms:9.3f} ms  x{n:<5d} {name}")
    shutil.rmtree(work, ignore_errors=True)
    return counts_all, engine


# ---------------------------------------------------------------------------
# phase 6: the minilm slice (IVF tier, MiniLM encoder, prefill on B4)
# ---------------------------------------------------------------------------


def median_s(torch, fn, reps=5):
    """Median host time of ``fn`` (ending in a device synchronise), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_minilm(torch, np, args, card, corpus, engine, dev):
    from repro_torch.api import EngineCfg, StorInfer, SystemCfg, tier_of
    from repro_torch.core.embedder import MiniLMEncoder
    from repro_torch.core.index import IVF_CACHE_NAME, ivf_params
    from repro_torch.core.runtime import BatchedRuntimeCfg
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import write_kb_store

    kb, pairs, tok, stream, exact = corpus
    work = ROOT / "build" / "chip_smoke" / "minilm"
    shutil.rmtree(work, ignore_errors=True)
    label = "slice minilm"
    enc = MiniLMEncoder(tok, seed=args.seed, device=dev)
    t0 = time.perf_counter()
    write_kb_store(work, kb, enc, N_STORE, seed=args.seed,
                   emb_dtype="float16").close()
    print(f"{label}: store of {N_STORE} pairs written in "
          f"{time.perf_counter() - t0:.2f} s ({len(pairs)} KB queries "
          "embedded by the port's MiniLM encoder on the card)")
    bucket = [q for q, _ in pairs[:256]]
    enc_s = median_s(torch, lambda: enc.encode(bucket))
    print(f"{label}: MiniLM encode of one 256-row bucket (6 layers, 384 "
          f"wide, max_len 64): {enc_s * 1e3:.2f} ms median of 5 on {card}")
    del enc
    cfg = SystemCfg(embedder="minilm", embedder_kw={"seed": args.seed},
                    s_th_run=S_TH_MINILM, decode_slots=4, device=str(dev),
                    batched=BatchedRuntimeCfg(add_misses=True,
                                              rebuild_every=8),
                    engine=EngineCfg(arch="qwen3-1.7b", smoke=False,
                                     max_len=160, chunk=8, seed=args.seed))
    n_lists, nprobe = ivf_params(N_STORE)
    cache = work / IVF_CACHE_NAME
    t0 = time.perf_counter()
    with StorInfer.open(work, cfg, tokenizer=tok, engine=engine) as si:
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        check(tier_of(si.index) == "ivf" and si.index.n_lists == n_lists
              and si.index.nprobe == nprobe
              and si.index.loaded_from is None and cache.exists(),
              f"{label}: default index='auto' did not fit and save the IVF "
              f"tier ({tier_of(si.index)}, cache {cache.exists()})")
    print(f"{label}: index='auto' picked {tier_of(si.index)!r} at "
          f"{N_STORE} rows, fitted {n_lists} lists (nprobe {nprobe}) and "
          f"wrote {IVF_CACHE_NAME} in {t_fit:.2f} s (open incl.)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    si = StorInfer.open(work, cfg, tokenizer=tok, engine=engine)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    with si:
        idx = si.index
        check(idx.loaded_from == str(cache),
              f"{label}: the second open refitted instead of loading")
        enc = si.embedder
        check(isinstance(enc, MiniLMEncoder) and enc.device == dev,
              f"{label}: embedder is not the port's MiniLM on {dev}")
        per_q = idx.nprobe * idx.cap * idx.lists.shape[2] * 4
        qmax = si._batched.cfg.max_batch
        print(f"{label}: second open loaded the fit in {t_load:.2f} s; "
              f"cap {idx.cap} rows per list, lists {idx.lists.numel() * 4 / 2**30:.3f} "
              f"GiB; probe gather {per_q / 2**20:.1f} MiB per query, "
              f"{qmax * per_q / 2**30:.3f} GiB for a {qmax}-query batch "
              "(scanned in chunks of at most 512 MiB)")

        # hits through the serving front door resolve at search time and
        # never reach decode: the flash launches are the embedder's alone
        hits_only = sorted(exact)[:8]
        ops.reset_launch_counts()
        with si.serve():
            futs = [si.submit(t, max_new=MAX_NEW) for t in hits_only]
            rh = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        c_hits = ops.launch_counts()
        print(f"{label}: hit-only serve() run, launches {c_hits}")
        check(all(r.hit for r in rh), f"{label}: a stored query missed")
        n_enc = enc.cfg.n_layers
        check(c_hits["flash_attention"] > 0
              and c_hits["flash_attention"] % n_enc == 0
              and c_hits["decode_attention"] == 0,
              f"{label}: the MiniLM embedder did not run on B4 ({c_hits})")
        ops.reset_launch_counts()
        rq = si.query_batch(hits_only, max_new=MAX_NEW)
        torch.cuda.synchronize()
        c_qb = ops.launch_counts()
        print(f"{label}: hit-only query_batch, launches {c_qb} (the decode "
              "races the search, so prefill may run before the hits cancel "
              "it)")
        check(all(r.hit for r in rq) and c_qb["flash_attention"] > 0,
              f"{label}: hit-only query_batch: {c_qb}")

        # the stream; forward passes of the encoder counted to split the
        # flash launches into the embedder's and prefill's
        fwd = []
        enc_forward = enc._forward
        enc._forward = lambda t, m: (fwd.append(1), enc_forward(t, m))[1]
        # serve() first: random MiniLM weights map an unanticipated
        # phrasing onto a written-back one of the same template and length
        # (score >= 0.99999), so the half served second mostly hits the
        # first half's write-backs; the serve() path is the one whose miss
        # latency users see
        _, counts, out, res = serve_slice(torch, np, si, stream, exact,
                                          dict(pairs), label,
                                          serve_first=True)
        enc._forward = enc_forward
        prefill_launches = counts["flash_attention"] - n_enc * len(fwd)
        n_llm = engine.cfg.n_layers
        print(f"{label}: flash_attention launches {counts['flash_attention']}"
              f" = {n_enc} x {len(fwd)} encoder passes + {prefill_launches} "
              f"prefill ({prefill_launches // n_llm} prompts x {n_llm} "
              "layers)")
        check(out["misses"] > 0, f"{label}: no miss, so no prefill ran")
        check(prefill_launches > 0 and prefill_launches % n_llm == 0
              and counts["decode_attention"] > 0,
              f"{label}: prefill or decode did not run on B4/B3 ({counts})")
        check(tier_of(si._batched.index) == "ivf",
              f"{label}: the rebuild left the IVF tier")
        groups = {"exact": [], "near": [], "unanticipated": []}
        for text, r in zip(stream, res):
            g = "exact" if text in exact else \
                "near" if text.startswith("hi, ") else "unanticipated"
            groups[g].append((r.score, r.hit))
        for g, v in groups.items():
            sc = np.asarray([x for x, _ in v])
            print(f"{label}: top-1 scores, {g} ({len(v)}, "
                  f"{sum(h for _, h in v)} hits at s_th_run {S_TH_MINILM}): "
                  "min/p10/p50/p90/max "
                  + " ".join(f"{x:.6f}" for x in np.percentile(
                      sc, [0, 10, 50, 90, 100])))
        recall = si._batched.index.recall_vs_flat(enc.encode(stream), k=1)
        print(f"{label}: IVF recall_vs_flat at k=1 on the stream's "
              f"embeddings: {recall:.4f}")
        out["recall_at_1"] = recall
        miss_text = next(t for t, r in zip(stream, res) if not r.hit)
        ids = engine.tok.encode(miss_text, bos=True)
        pre_s = median_s(torch, lambda: engine._prefill(engine.tokens(ids)))
        print(f"{label}: prefill of one {len(ids)}-token prompt ({n_llm} "
              f"layers, attention on B4): {pre_s * 1e3:.2f} ms median of 5 "
              f"on {card}")
        peak = torch.cuda.max_memory_allocated()
        out["peak_mem_gib"] = peak / 2 ** 30
        print(f"{label}: peak device memory {peak / 2**30:.3f} GiB on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return {"minilm hits": c_hits, "minilm query_batch": c_qb,
            "minilm": counts}


# ---------------------------------------------------------------------------
# phase 7: the offline build (StorInfer.build, PrecomputePipeline, TorchLM)
# ---------------------------------------------------------------------------


def same_store(a, b):
    """Names of the files of two store directories that differ, byte for
    byte; the manifest compared without the build clock (``elapsed``)."""
    from repro_torch.core.precompute import STATE_KEY

    def manifest(p):
        man = json.loads((p / "manifest.json").read_text())
        man.get("extra", {}).get(STATE_KEY, {}).pop("elapsed", None)
        return man

    names = sorted(p.name for p in a.iterdir())
    if names != sorted(p.name for p in b.iterdir()):
        return ["<file lists>"]
    return [f for f in names
            if (manifest(a) != manifest(b) if f == "manifest.json"
                else (a / f).read_bytes() != (b / f).read_bytes())]


def check_invariant(torch, np, store, s_th, dev, label):
    """No stored row at or above ``s_th`` against an EARLIER one, over the
    stored (dtype round-tripped) embeddings, in one f32 product on
    ``dev``."""
    n = store.count
    e = torch.from_numpy(np.ascontiguousarray(
        store.embeddings().take(np.arange(n)), np.float32)).to(dev)
    g = torch.tril(e @ e.T, diagonal=-1)
    g = g.masked_fill(torch.triu(torch.ones_like(g, dtype=torch.bool)),
                      -float("inf"))
    top = float(g.max()) if n > 1 else -float("inf")
    n_at = int((g >= s_th).sum())
    check(top < s_th + TOL_SIM_ORDER,
          f"{label}: a pair was accepted at {top:.7f} >= s_th_gen {s_th} "
          "against an earlier one")
    print(f"{label}: dedup invariant holds: max similarity to an earlier "
          f"row {top:.7f} < s_th_gen {s_th} ({n_at} pairs within "
          f"{TOL_SIM_ORDER:g} at or above it, f32 summation order)")


def wave_clock():
    """An ``on_wave`` callback that stamps each wave; returns (callback,
    per-wave seconds)."""
    stamps = [time.perf_counter()]

    def on_wave(waves, generated, discarded, mode):
        stamps.append(time.perf_counter())

    return on_wave, lambda: [b - a for a, b in zip(stamps, stamps[1:])]


def phase_build_llm(torch, np, args, card, corpus, engine, work):
    """7a: the LLM-driven build. TorchLM over phase 4's weights (no copy)
    at the generator's context (GenCfg.max_ctx = 512)."""
    from repro_torch.api import StorInfer, SystemCfg
    from repro_torch.core.generator import GenCfg
    from repro_torch.core.precompute import STATE_KEY, PrecomputeCfg
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.lm import TorchLM

    kb, tok = corpus[0], corpus[2]
    label = "build 7a (LLM)"
    gen = GenCfg()
    lm_engine = Engine(engine.cfg, engine.params, engine.tok,
                       max_len=gen.max_ctx, chunk=8)
    check(lm_engine.params is engine.params, f"{label}: weights copied")
    lm = TorchLM(lm_engine)
    prompt_lens, queries = [], []
    generate, generate_query = lm_engine.generate, lm.generate_query

    def counted_generate(prompt, **kw):
        prompt_lens.append(len(lm_engine.tok.encode(prompt, bos=True)))
        return generate(prompt, **kw)

    def recorded_query(*a):
        queries.append(generate_query(*a))
        return queries[-1]

    lm_engine.generate, lm.generate_query = counted_generate, recorded_query
    cfg = SystemCfg(index="flat", device=str(engine.device), gen=gen,
                    precompute=PrecomputeCfg(wave=4, max_attempts_factor=2))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    si = StorInfer.build(kb, cfg, work / "llm", n_pairs=N_BUILD_LLM, lm=lm,
                         tokenizer=tok)
    with si:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = si.build_stats
        counts = ops.launch_counts()
        state = si.store.manifest_extra[STATE_KEY]
        temps, attempts = state["temps"], state["attempts"]
        # a wave that reaches the target drops its tail: those candidates
        # count as attempts, neither accepted nor discarded
        check(attempts == len(queries) and si.store.count == st.generated,
              f"{label}: {attempts} attempts, {len(queries)} queries")
        print(f"{label}: {attempts} attempts, {st.generated} accepted, "
              f"{st.discarded} discarded (cap {N_BUILD_LLM * 2 + 100}); "
              f"{sum(q == '' for q in queries)} of {len(queries)} generated "
              f"queries empty; final temperatures per chunk "
              f"{sorted(set(round(t, 2) for t in temps))} (max "
              f"{st.temp_final:.2f})")
        print(f"{label}: {st.run_seconds / attempts:.3f} s per attempted "
              f"pair, {st.run_seconds / max(st.generated, 1):.3f} s per "
              f"accepted pair (paper: {PAPER_S_PER_PAIR} s per pair on an "
              f"H100) on {card}; build {st.run_seconds:.2f} s, with the "
              f"open {wall:.2f} s")
        print(f"{label}: {len(prompt_lens)} prompts through the 512-token "
              f"engine, {min(prompt_lens)}-{max(prompt_lens)} tokens; "
              f"launches {counts}")
        check(counts["flash_attention"] > 0 and counts["decode_attention"] > 0,
              f"{label}: prefill or decode did not run on B4/B3 ({counts})")
        check_invariant(torch, np, si.store, gen.s_th_gen, engine.device,
                        label)
    with StorInfer.open(work / "llm", SystemCfg(index="flat",
                                                device=str(engine.device))) \
            as si2:
        check(si2.store.count == st.generated
              and si2.store.get_pair(0)[0] == queries[0],
              f"{label}: the store did not reopen")
    print(f"{label}: store reopened, {st.generated} pairs")
    return counts


def phase_build_default(torch, np, args, card, work, dev):
    """7b: the reference launcher's default build (oracle LM, hash
    embedder, fp16 store, index="auto"), the dedup index crossing into IVF
    on the card at 2,048, 4,096 and 8,192 rows."""
    from repro_torch.api import StorInfer, SystemCfg, tier_of
    from repro_torch.core.kb import build_kb
    from repro_torch.core.precompute import PrecomputeCfg
    from repro_torch.kernels import ops

    label = "build 7b (launcher default)"
    kb = build_kb("squad", seed=args.seed, n_docs=200)
    cfg = SystemCfg(embedder="hash", index="auto", emb_dtype="float16",
                    device=str(dev), precompute=PrecomputeCfg(
                        wave=32, checkpoint_every=64, flat_max_rows=2048))
    on_wave, wave_s = wave_clock()
    ops.reset_launch_counts()
    si = StorInfer.build(kb, cfg, work / "default", n_pairs=N_BUILD,
                         seed=args.seed, resume=False, on_wave=on_wave)
    with si:
        st = si.build_stats
        ws = sorted(wave_s())
        sb = si.store.storage_bytes()
        print(f"{label}: {si.store.count} pairs in {st.run_seconds:.2f} s, "
              f"{st.pairs_per_sec:.1f} pairs/s, {st.discarded} discarded, "
              f"{st.waves} waves (max {ws[-1] * 1e3:.2f} ms, median "
              f"{ws[len(ws) // 2] * 1e3:.2f} ms); dedup index ended "
              f"{st.index_mode} after {st.refits} refits (k-means + "
              "reassignment: " + ", ".join(f"{t * 1e3:.1f} ms"
                                           for t in st.refit_seconds)
              + f"); store {sb['total_bytes'] / 1e6:.2f} MB; serving index "
              f"{tier_of(si.index)} in {si.index_seconds:.3f} s on {card}")
        check(si.store.count == N_BUILD and st.index_mode == "ivf"
              and st.refits == 3 and tier_of(si.index) == "flat",
              f"{label}: rows {si.store.count}, dedup {st.index_mode}, "
              f"refits {st.refits}, serving {tier_of(si.index)}")
        rows = np.random.default_rng(args.seed).choice(N_BUILD, 32,
                                                       replace=False)
        pairs = [si.store.get_pair(int(r)) for r in rows]
        res = si.query_batch([q for q, _ in pairs], max_new=1)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(all(r.hit and r.matched_query == q and r.response == a
                  for r, (q, a) in zip(res, pairs)),
              f"{label}: a stored query did not hit its own row")
        check(counts["mips_topk"] > 0, f"{label}: B1 not launched {counts}")
        print(f"{label}: 32 stored queries hit their rows through "
              f"query_batch; launches {counts}")
    return counts


def phase_build_resume(torch, np, args, work, dev):
    """7c: an int8 build killed about halfway and resumed, against an
    uninterrupted one: every file equal. The dedup index crosses into IVF
    (flat_max_rows 256); the resumed build rebuilds it shard by shard."""
    from repro_torch.api import StorInfer, SystemCfg
    from repro_torch.core.kb import build_kb
    from repro_torch.core.precompute import BuildKilled, PrecomputeCfg
    from repro_torch.kernels import ops

    label = "build 7c (kill/resume, int8)"
    kb = build_kb("squad", seed=args.seed, n_docs=200)
    cfg = SystemCfg(index="auto", quantize=True, device=str(dev),
                    shard_rows=256, precompute=PrecomputeCfg(
                        wave=32, checkpoint_every=4, flat_max_rows=256))
    ops.reset_launch_counts()
    with StorInfer.build(kb, cfg, work / "whole", n_pairs=N_BUILD_RESUME,
                         seed=args.seed) as si:
        waves = si.build_stats.waves
        check(si.build_stats.index_mode == "ivf",
              f"{label}: the dedup index stayed {si.build_stats.index_mode}")
    kill = waves // 2 + 1
    try:
        StorInfer.build(kb, cfg, work / "resumed", n_pairs=N_BUILD_RESUME,
                        seed=args.seed, _kill_after_waves=kill)
        raise SmokeFailure(f"{label}: the kill hook did not fire")
    except BuildKilled:
        pass
    with StorInfer.build(kb, cfg, work / "resumed", n_pairs=N_BUILD_RESUME,
                         seed=args.seed) as si:
        st = si.build_stats
        bad = same_store(work / "whole", work / "resumed")
        print(f"{label}: {waves} waves uninterrupted; killed after {kill}, "
              f"resumed from {st.resumed_rows} rows ({st.refits} refits in "
              f"the resumed run); files differing: {bad or 'none'}")
        check(not bad and 0 < st.resumed_rows < N_BUILD_RESUME,
              f"{label}: the resumed store differs ({bad})")
        pairs = [si.store.get_pair(r) for r in range(0, N_BUILD_RESUME, 32)]
        res = si.query_batch([q for q, _ in pairs], max_new=1)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(si.index.dev.quantized and all(
            r.hit and r.response == a for r, (_, a) in zip(res, pairs)),
            f"{label}: the int8 store did not serve its rows")
        check(counts["mips_topk_int8"] > 0,
              f"{label}: B2 not launched {counts}")
        print(f"{label}: {len(pairs)} stored queries hit on the int8 store; "
              f"launches {counts}")
    return counts


def phase_build_devices(torch, np, args, work, dev):
    """7d: the dedup decisions do not depend on where the product ran: a
    flat-mode hash build with the index on the card and on the CPU."""
    from repro_torch.api import StorInfer, SystemCfg
    from repro_torch.core.kb import build_kb
    from repro_torch.core.precompute import PrecomputeCfg

    label = "build 7d (device independence)"
    kb = build_kb("squad", seed=args.seed, n_docs=200)
    secs = {}
    for d in (str(dev), "cpu"):
        cfg = SystemCfg(index="none", device=d, precompute=PrecomputeCfg(
            wave=32, flat_max_rows=4 * N_BUILD_DEVICE))
        with StorInfer.build(kb, cfg, work / f"dev_{d}",
                             n_pairs=N_BUILD_DEVICE, seed=args.seed) as si:
            check(si.build_stats.index_mode == "flat",
                  f"{label}: left flat mode")
            secs[d] = si.build_stats.run_seconds
    bad = same_store(work / f"dev_{dev}", work / "dev_cpu")
    print(f"{label}: {N_BUILD_DEVICE} pairs, dedup index on {dev} "
          f"{secs[str(dev)]:.2f} s, on the CPU {secs['cpu']:.2f} s; files "
          f"differing: {bad or 'none'}")
    check(not bad, f"{label}: the stores differ ({bad})")


def phase_build_minilm(torch, np, args, corpus, work, dev):
    """7e: a build embedded by the port's MiniLM encoder (B4 non-causal).
    Random MiniLM weights score any two texts near 1, hence the
    threshold."""
    from repro_torch.api import StorInfer, SystemCfg
    from repro_torch.core.generator import GenCfg
    from repro_torch.core.precompute import PrecomputeCfg
    from repro_torch.kernels import ops

    kb, tok = corpus[0], corpus[2]
    label = "build 7e (MiniLM)"
    gen = GenCfg(s_th_gen=0.9999)
    cfg = SystemCfg(embedder="minilm", embedder_kw={"seed": args.seed},
                    index="none", device=str(dev), gen=gen,
                    precompute=PrecomputeCfg(wave=32))
    ops.reset_launch_counts()
    with StorInfer.build(kb, cfg, work / "minilm", n_pairs=N_BUILD_MINILM,
                         tokenizer=tok, seed=args.seed) as si:
        torch.cuda.synchronize()
        st = si.build_stats
        counts = ops.launch_counts()
        print(f"{label}: {si.store.count} pairs, {st.discarded} discarded "
              f"at s_th_gen {gen.s_th_gen}, {st.pairs_per_sec:.1f} pairs/s; "
              f"launches {counts}")
        check(counts["flash_attention"] > 0,
              f"{label}: the encoder did not run on B4 ({counts})")
        check_invariant(torch, np, si.store, gen.s_th_gen, dev, label)
    return counts


def phase_build(torch, np, args, card, corpus, engine, dev):
    work = ROOT / "build" / "chip_smoke" / "build"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    t0 = time.perf_counter()
    out["build llm"] = phase_build_llm(torch, np, args, card, corpus, engine,
                                       work)
    out["build default"] = phase_build_default(torch, np, args, card, work,
                                               dev)
    out["build resume"] = phase_build_resume(torch, np, args, work, dev)
    phase_build_devices(torch, np, args, work, dev)
    out["build minilm"] = phase_build_minilm(torch, np, args, corpus, work,
                                             dev)
    print(f"build: phase 7 took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds every input: store, weights, queries")
    args = ap.parse_args()

    # -- phase 1: device -----------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device — chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    print(f"device: {name} ({torch.cuda.device_count()} visible), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {card}")

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = ops.build_kernels()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s "
          "(nvcc, sm_90a, one process per source)")
    for k, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(f"build {k}: {line.strip()}")

    # -- phase 3: kernels vs plain -------------------------------------------
    corpus = make_corpus(args.seed)
    tok, stream, exact = corpus[2], corpus[3], corpus[4]
    unanticipated = [t for t in stream
                     if t not in exact and not t.startswith("hi, ")]
    rows = phase_kernels(torch, np, args, dev,
                         len(tok.encode(unanticipated[0], bos=True)), logs)

    # -- phases 4, 5: the slice, fp16 then int8 -------------------------------
    counts, engine = phase_slices(torch, np, args, card, corpus)

    # -- phase 6: the minilm slice (IVF, MiniLM on B4, prefill on B4) ---------
    counts.update(phase_minilm(torch, np, args, card, corpus, engine, dev))

    # -- phase 7: the offline build -------------------------------------------
    counts.update(phase_build(torch, np, args, card, corpus, engine, dev))
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
