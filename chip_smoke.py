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
   the serving shapes plus a ragged case, timed with CUDA events beside
   the plain version and a one-call PyTorch yardstick;
4. slice, fp16 store — writes the paper's 150,000-pair store, opens it
   with ``StorInfer.open`` (flat index, qwen3-1.7b at full width, random
   weights from ``--seed``) and serves a mixed stream through
   ``query_batch`` and ``serve()``/``submit()``, with a §3.1 write-back
   and delta rebuild;
5. slice, int8 store — the same stream over an int8 store.

The kernels' launch counters are set to 0 just before each slice and read
just after it: every kernel of the path must have run there. The last
lines are one JSON line of per-kernel numbers, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
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
F32_FLOPS = 67e12            # CUDA cores, the f32 FMAs of B1 and B3
INT8_OPS = 1979e12           # int8 rate, B2's int8 products
TOL_F32 = 1e-5               # B1 contract (rtol and atol)
TOL_DECODE_F32 = 2e-4        # B3 contract with an f32 cache
# B3 with a bf16 cache: the kernel rounds the unnormalised exp(s - m_split)
# to bf16 before P.V, the plain version the normalised probability, so a
# term may differ by one bf16 ulp of p (2^-8 relative); 1e-2 absolute on
# outputs of unit-scale values.
TOL_DECODE_BF16 = 1e-2
MAX_NEW = 16
N_STORE = 150000             # the paper's store size (pairs)


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
    (profiled alone). None when the trace holds no device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    step = fn if flush is None else (lambda: (flush.add_(1), fn()))
    tot = _profiled_us(torch, step, iters, kernel)
    if flush is not None and kernel is None:
        tot -= _profiled_us(torch, lambda: flush.add_(1), iters)
    return tot / iters / 1e3 if tot > 0 else None


def timed(torch, fn, iters, flush=None, kernel=None):
    """(device ms from the profiler, or the event time when the trace has
    none; the event time per call, host gaps included)."""
    call = time_ms(torch, fn, iters, flush)
    dev = device_ms(torch, fn, iters, flush, kernel)
    return (dev if dev is not None else call), call


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


def phase_kernels(torch, np, args, dev):
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
    for dt in (torch.float32, torch.bfloat16):
        check_mips(torch, ops, ref, unit_rows(torch, g, 5, 100, dev),
                   unit_rows(torch, g, 1000, 100, dev).to(dt), 7, 512,
                   f"ragged N=1000 D=100 k=7 {dt}")
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
    ms, call = timed(torch, lambda: mt.mips_topk_tiles_cuda(
        ops._lib("mips_topk"), q, x, k, tn), 50, flush, "mips_topk_kernel")
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
          f"{lib:.4f} ms, on a store upcast beforehand {lib_gemm:.4f} ms "
          "(device time per call)")
    nt = -(-N // tn)
    b_ms, b_by = bound(nb(q, x) + nt * Q * k * 8, 2 * Q * N * D, F32_FLOPS)
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
    ms, call = timed(torch, lambda: mt8.mips_topk_int8_tiles_cuda(
        ops._lib("mips_topk_int8"), q8, qs, x8, xs, k, tn), 50, flush,
        "mips_topk_int8_kernel")
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
    lib_da = ops._lib("decode_attention")

    def b3_case(T_, lengths, dt, ns_, tol, label):
        qq = torch.randn((B, Hq, Dh), generator=g, device=dev)
        kk = torch.randn((B, T_, Hkv, Dh), generator=g, device=dev).to(dt)
        vv = torch.randn((B, T_, Hkv, Dh), generator=g, device=dev).to(dt)
        o, m, l = da.decode_partials_cuda(lib_da, qq, kk, vv, lengths, ns_)
        op, mp, lp = da.decode_partials_plain(qq, kk, vv, lengths, ns_)
        # the wrapper gqa_decode calls: kernel + combine_splits
        got = ops.decode_attention(qq, kk, vv, lengths, ns_)
        want = da.decode_attention_plain(qq, kk, vv, lengths)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(torch.allclose(m, mp, rtol=1e-5, atol=1e-5)
              and torch.allclose(l, lp, rtol=1e-4, atol=1e-4)
              and torch.allclose(o, op, rtol=tol, atol=tol)
              and torch.allclose(got, want, rtol=tol, atol=tol),
              f"B3 {label}: differs from plain (max {e})")
        print(f"B3 {label}: ok max_abs_err={e:.3e} (tol {tol})")
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
    ms, call = timed(torch, lambda: da.decode_partials_cuda(
        lib_da, qq, kk, vv, main_len, ns), 200, None,
        "decode_attention_kernel")
    plain, plain_call = timed(torch, lambda: da.decode_partials_plain(
        qq, kk, vv, main_len, ns), 50)
    wrapper, wrapper_call = timed(torch, lambda: ops.decode_attention(
        qq, kk, vv, main_len, ns), 200)
    pos = torch.arange(T, device=dev)
    mask = (pos[None, :] <= main_len[:, None])[:, None, None, :]
    qs_ = qq.to(kk.dtype)[:, :, None, :]
    kt, vt = kk.transpose(1, 2), vv.transpose(1, 2)
    lib, lib_call = timed(torch, lambda: F.scaled_dot_product_attention(
        qs_, kt, vt, attn_mask=mask, enable_gqa=True), 200)
    att = int((main_len.clamp(max=T - 1) + 1).sum())
    kv_bytes = att * Hkv * Dh * kk.element_size() * 2
    out_bytes = B * ns * Hq * (Dh + 2) * 4
    b_ms, b_by = bound(nb(qq, main_len) + kv_bytes + out_bytes,
                       4 * att * Hq * Dh, F32_FLOPS)
    print(f"B3 wrapper (kernel + combine_splits): device {wrapper:.4f} ms, "
          f"call {wrapper_call:.4f} ms")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention.py:47",
                     max_abs_err=err3, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     calls=(call, plain_call, lib_call)))
    for r in rows:
        c = r["calls"]
        print(f"timing {r['name']} (device time per call, profiler): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); per call with host gaps (CUDA events): "
              f"kernel {c[0]:.4f}, plain {c[1]:.4f}, library {c[2]:.4f} ms")
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


def serve_slice(torch, np, si, stream, exact, answers, label):
    """query_batch over half the stream, serve()/submit() over the other
    half; checks every result and returns the per-query (hit, row text)
    plus the latency numbers."""
    from repro_torch.kernels import ops
    dev_store = si._batched.index.dev
    up0, rows0 = dev_store.uploads, dev_store.n_rows
    half = len(stream) // 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = si.query_batch(stream[:half], max_new=MAX_NEW)
    t_qb = time.perf_counter() - t0
    with si.serve():
        futs = [si.submit(t, max_new=MAX_NEW) for t in stream[half:]]
        res += [f.result(timeout=600) for f in futs]
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
    check(b.stats.index_rebuilds >= 1 and b.index.dev.uploads > up0
          and b.index.dev.n_rows > rows0,
          f"{label}: no §3.1 write-back + delta rebuild "
          f"(rebuilds={b.stats.index_rebuilds}, uploads {up0}->"
          f"{b.index.dev.uploads})")
    hits = [r for r in res if r.hit]
    misses = [r for r in res if not r.hit]
    served = res[half:]
    out = {
        "hits": len(hits), "misses": len(misses),
        "writebacks": b.stats.writebacks, "rebuilds": b.stats.index_rebuilds,
        "delta_uploads": b.index.dev.uploads - up0,
        "query_batch_s": t_qb,
        "hit_p50_ms": pct([r.latency_s for r in served if r.hit], 50),
        "hit_p99_ms": pct([r.latency_s for r in served if r.hit], 99),
        "miss_p50_ms": pct([r.latency_s for r in served if not r.hit], 50),
        "miss_p99_ms": pct([r.latency_s for r in served if not r.hit], 99),
        "qb_hit_p50_ms": pct([r.latency_s for r in res[:half] if r.hit], 50),
        "qb_miss_p50_ms": pct([r.latency_s for r in res[:half]
                               if not r.hit], 50),
    }
    print(f"{label}: " + json.dumps(out))
    return [(r.hit, r.response if r.hit else None) for r in res], counts, out


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
    return wall, busy, top, cpu, ops


def phase_slices(torch, np, args, card):
    from repro_torch.api import EngineCfg, StorInfer, SystemCfg
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.core.kb import build_kb
    from repro_torch.core.runtime import BatchedRuntimeCfg
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.launch.serve import kb_pairs, write_kb_store

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    kb = build_kb("squad", n_docs=20)
    pairs = kb_pairs(kb)
    answers = dict(pairs)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=2048)
    stream, exact = make_stream(kb, pairs, args.seed)
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
            res, counts, out = serve_slice(torch, np, si, stream, exact,
                                           answers, f"slice {label}")
            results[label] = (res, out)
            counts_all[label] = counts
            need = ("mips_topk" if dtype == "float16" else "mips_topk_int8",
                    "decode_attention")
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
    wall, busy, top, cpu, n_ops = decode_profile(torch, engine, miss_prompt,
                                                 4)
    print(f"decode chunk profile (batch 4, {engine.chunk} steps, profiler "
          f"on): wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, "
          f"device idle share {1 - busy / wall:.3f}, {n_ops} aten ops")
    for name, ms, n in top:
        print(f"  device {ms:9.3f} ms  x{n:<5d} {name}")
    for name, ms, n in cpu:
        print(f"  host   {ms:9.3f} ms  x{n:<5d} {name}")
    shutil.rmtree(work, ignore_errors=True)
    return counts_all


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
    rows = phase_kernels(torch, np, args, dev)

    # -- phases 4, 5: the slice, fp16 then int8 -------------------------------
    counts = phase_slices(torch, np, args, card)
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
