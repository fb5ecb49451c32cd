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
   build (the encoder on B4, non-causal);
8. slice paper8b — the paper's own serving model, storinfer-paper-8b at
   full width and depth (fp32 random weights from ``--seed``), behind
   phase 4's store, stream and system (its queues set through
   ``SystemCfg.queue_depth``): latencies, decode rates, a profiled decode
   chunk, and the §4 effective latency beside the analytic H100 model;
9. dense family — storinfer-paper-1b, llama3.2-3b and starcoder2-7b at
   full width and depth, qwen2.5-32b at full width with 16 of its 64
   layers (printed on a ``reduced:`` line): a KB prompt's prefill and 16
   greedy tokens at batch 1 and 4;
10. minilm train — ``MiniLMEncoder.train_contrastive`` on the card over
   the KB's paraphrase pairs; its first step against the CPU's, and the
   query groups' top-1 scores before and after;
11. slice moe — deepseek-v2-lite-16b (MLA + MoE) at full width and depth
   behind phase 8's store, stream and system, with phase 8's readings;
   its prefill runs MLA's expanded heads on B4 (v zero-padded to the q/k
   width), its absorbed decode is plain PyTorch, so B3 shows 0 launches
   there (printed with the reason);
12. families — grok-1-314b (moe with GQA) at full width with the 3 of its
   64 layers that fit (a ``reduced:`` line), mamba2-130m (ssm) and
   zamba2-1.2b (hybrid) at full width and depth, as phase 9 runs the
   dense family; mamba2 is attention-free and launches no kernel.

13. encdec + vlm — whisper-base (encdec) at full size and qwen2-vl-72b
   (vlm, M-RoPE) at full width with 16 of its 80 layers (a ``reduced:``
   line), through the model API (``prefill`` with frames or M-RoPE
   positions, ``decode_step``): a KB prompt's prefill (whisper: random
   frame embeddings from ``--seed``, the reference's stub frontend;
   qwen2-vl: a text prefix, a 4 x 4 image block and a text suffix) and
   16 greedy tokens at batch 1 and 4; encoder, prefill and decode times,
   peak memory, B3 and B4 launches;
14. train — qwen3-1.7b at full width and depth in mixed precision (bf16
   params, f32 AdamW state) on the KB's text at 4 x 256 tokens with the
   blockwise attention: accum 2 against 1, the loss on a repeated batch,
   s per step and tokens/s, a checkpoint saved, restored and stepped bit
   for bit as the uninterrupted run, one compressed step; B4 must show 0
   launches (it has no backward).
15. mesh — run after phase 7, over phase 4's store, stream and engine:
   the serving paths over a (data 1, model 4) mesh whose four shards all
   lie on the one card (a ``reduced:`` line): (a) ``StorInfer.open(...,
   mesh=)`` with ``index="auto"`` picks the sharded tier at 150,000 rows
   and serves phase 4's stream with the §3.1 rebuild (the same hits and
   responses as phase 4, B1 once a shard per search), then phase 5's int8
   store (top-1 equal to a plain f32 x dequantized scan, >= 0.99 with
   B2); (b) qwen3-1.7b's 16 greedy tokens at batch 4 with the
   seq-sharded decode attention, identical to the one-device decode (B3);
   (c) one MLA layer and (d) one MoE layer (expert parallel) at
   deepseek-v2-lite-16b's widths against one device.
16. mesh train — phase 14's state on a (data 2, model 2) mesh of the card:
   restored bit for bit, one step against one device's, three more steps,
   saved and restored onto (data 1, model 4) bit for bit.
17. multihost train — (a) the launcher's ``--multipod --pods 2`` at the
   reduced config: refused under NCCL (two ranks on one card), trained
   over ``gloo``; (b) two pods, one process each (``gloo``) on the card,
   each restoring phase 14's checkpoint onto its (data 1, model 1) mesh:
   one step on its rows ``[p::2]`` of phase 16's batch against phase 16's
   one-device step, the ranks' state identical after every step, two more
   steps, the gradient all-reduce timed; rank 0's checkpoint restored onto
   one device bit for bit (a ``reduced:`` line: the pods share one card).
18. examples — ``examples/{quickstart,storinfer_serve,train_small}_torch
   .py`` called in process on the card: the quickstart's hit rate as on
   the CPU, the serve example on B1, B3 and B4 with request 1 cancelled,
   the train example trained, then resumed, its loss falling.
19. dry run — the dry-run tooling (``launch/dryrun.py``) held against the
   card: (a) qwen3-1.7b ``decode_32k`` on the production pod16x16 mesh,
   counted on 256 meta shards on this host (depth-1/2 probes), its memory
   and roofline terms; (b) two ``build_cell`` plans on a (data 1, model 1)
   mesh, qwen3-1.7b trained at phase 14's 4 x 256 tokens and decoding the
   full 32,768-token cache at the largest batch predicted to fit in 60
   GB (``reduced:`` lines), each counted on meta and then run on the card:
   the predicted peak within 10% of the measured ``max_memory_allocated``
   above what the run started with, and the measured device time of a
   step no shorter than the predicted bound (their share at most 1.05);
   (c) B1, B2, B3 and B4 (a) at phase 3's shapes under the counter on the
   card, one launch each, crediting the same product FLOPs and least bytes
   as the same call on CPU copies.

Phase 3 also holds B3 and B4 at grok-1's and zamba2's head shapes, B4 at
MLA's (q/k 192, v 128), and both at phase 13's: whisper-base's encoder
(B 1 and 4, S = T = 1500, non-causal) and cross-attention prefill (a KB
prompt over 1500 frames) on B4, its cross-attention decode (T = 1500,
lengths 1499, f32 and bf16) on B3, qwen2-vl-72b's 64/8 heads of 128 on
both; each new shape is also timed beside its bound and SDPA.

The kernels' launch counters are set to 0 just before each serving run,
each build and each engine or training run of phases 8-15 and read just
after it: every kernel of the path must have run there. The
last lines are one JSON line of per-kernel numbers, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (the package's, from NVIDIA's data sheet, dense): the
# bound of each kernel. F32_FLOPS on the CUDA cores takes B3's f32 FMAs;
# on the tensor cores a B1 product is two TF32 products with a 16-bit
# store (2xTF32), three with an f32 store, as is a B4 f32 product
# (3xTF32); INT8_OPS takes B2's int8 products.
from repro_torch.launch.dryrun import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                       HBM_BYTES_S, INT8_OPS, TF32_FLOPS)
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
# the dense family's attention shapes at full width, (query heads, kv
# heads, head dim): B3 and B4 are held to their plain versions at each
DENSE_HEADS = [("storinfer-paper-8b", 32, 8, 128),
               ("storinfer-paper-1b", 32, 8, 64),
               ("llama3.2-3b", 24, 8, 128),
               ("starcoder2-7b", 36, 4, 128),
               ("qwen2.5-32b", 40, 8, 128)]
# the moe, ssm and hybrid families' GQA shapes at full width: grok-1's
# 48/8 heads of 128 (G = 6) and zamba2's shared block, 32/32 of 64 (G = 1)
FAMILY_HEADS = [("grok-1-314b", 48, 8, 128), ("zamba2-1.2b", 32, 32, 64)]
WHISPER_FRAMES = 1500        # whisper-base's encoder_seq (phase 13)
# phase 13: qwen2-vl-72b at full width, fp32: 877.8 M parameters (3.27
# GiB) a layer plus 9.28 GiB of untied embedding and head, so 16 of its 80
# layers are 61.6 GiB; 20 (74.7 GiB) would leave under 5 GiB
VLM_LAYERS = 16
# phase 14: qwen3-1.7b trained at full width and depth, bf16 params and
# f32 AdamW state (34 GiB before activations), KB text at 4 x 256 tokens,
# with the reference's AdamW defaults (lr 3e-4 after 100 warmup steps).
# Without the warmup the first steps diverge from random weights: Adam
# moves every weight by about lr in one step, and at lr 3e-4 (and 1e-3)
# with one warmup step the loss on a repeated batch went 12.2, 8.9, 18.4,
# 9.8, 6.8, 12.7 (NVIDIA H100 80GB HBM3, 700.00 W)
LM_TRAIN_ARCH = "qwen3-1.7b"
LM_BATCH, LM_SEQ = 4, 256
LM_REPEAT, LM_TIMED = 6, 5
TRAIN_CKPT = ROOT / "build" / "chip_smoke" / "train_ckpt"   # 14 -> 16, 17
# accum 2 against accum 1 after one step from a fresh state: the bf16
# forward and backward of two half batches against one whole batch round
# differently, so the loss (a mean over the same 1,024 labels) agrees to
# bf16 accuracy and the grad norm to about 1%; Adam's first update is
# about lr times the sign of each gradient, so a master whose gradient
# is near 0 may move by up to 2 lr (of step 1) more in one than in the
# other (plus the f32 rounding of masters below 1: 1e-6)
TOL_ACCUM_LOSS, TOL_ACCUM_NORM = 1e-3, 1e-2
# deepseek-v2-lite's MLA prefill on B4: 16 heads, q/k 192 (nope 128 + rope
# 64), v 128 (zero-padded to 192 by the wrapper)
MLA_SHAPE = (1, 160, 160, 16, 16, 192, 128)
# phase 9: the rest of the dense family at full width; qwen2.5-32b's 64
# layers in fp32 (122 GiB) do not fit in 80 GB, so it runs 16 of them
DENSE_FAMILY = [("storinfer-paper-1b", None), ("llama3.2-3b", None),
                ("starcoder2-7b", None), ("qwen2.5-32b", 16)]
PAPER_8B = "storinfer-paper-8b"
MOE_ARCH = "deepseek-v2-lite-16b"  # phase 11
# phase 12: grok-1-314b at full width, fp32: 18.3 GiB a layer plus 6.0 GiB
# of embedding and head, so 3 of its 64 layers fit in 80 GB and 4 do not
GROK_LAYERS = 3
QUEUE_DEPTH = 16             # phase 8's staged-pipeline queues (SystemCfg)
# phase 10: MiniLM contrastive training on the card. From random weights
# the full-size encoder maps every text near one vector (the position
# table dominates), so the reference's momentum SGD (no clipping) moves
# slowly at the reference test's lr 2e-3, and at lr 0.05 and above it
# falls and then collapses back to the uniform loss (2 ln 32) within 200
# steps (seed 0, on the CPU); 0.02 stays below that.
TRAIN_STEPS, TRAIN_BS, TRAIN_LR = 200, 32, 0.02
TOL_TRAIN = 1e-4             # the first steps' losses, card vs CPU (relative)
# At TRAIN_LR the first steps move the weights by a few ulps of f32 (of
# weights of size 1) and the loss by less than TOL_TRAIN, so neither shows
# a wrong update. A copy therefore takes TRAIN_CHECK_STEPS steps at
# TRAIN_CHECK_LR, where the update is far above that spacing, on the card
# and on the CPU, and the two updates are held together relative to the
# largest. The encoder's pooled vectors nearly coincide, so the gradient
# is a difference of close numbers and two f32 runs that sum in other
# orders agree to about 1e-4 of it; a wrong or missing update is off by
# order 1.
TRAIN_CHECK_STEPS, TRAIN_CHECK_LR = 2, 5000.0
TOL_TRAIN_UPDATE = 1e-3
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


def time_ms(torch, fn, iters, flush=None, warm=3):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events
    around each call, after ``warm`` calls; ``flush`` is written between
    calls so a large operand is not found in L2)."""
    for _ in range(warm):
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


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _profiled_us(torch, fn, iters, kernel=None):
    """(summed device time in us, number of device activities) of what
    ``fn`` issues over ``iters`` calls, from a torch.profiler trace
    (CUPTI); the time of the kernels whose name contains ``kernel`` only,
    when one is given."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, 0
    for e in prof.key_averages():
        t = _dev_us(e)
        seen += t > 0
        if kernel is not None and kernel not in e.key:
            continue
        total += t
    return total, seen


PROFILE_TRIES = 3   # traces taken before a call is timed with CUDA events


def device_ms(torch, fn, iters, flush=None, kernel=None, warm=3):
    """Device time per call (ms) from the profiler: the named kernel's
    time, or every device activity of the call minus the L2 flush's
    (profiled alone). A trace that holds device activity but none whose
    name holds ``kernel`` fails the run: a renamed kernel must not be
    timed as something else. A trace with no device time at all (CUPTI
    recorded nothing, or the flush's own spread swallowed the call) is
    taken again; after ``PROFILE_TRIES`` such traces the call is timed
    with CUDA events instead, and stderr says so. ``warm`` calls first."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    step = fn if flush is None else (lambda: (flush.add_(1), fn()))
    for attempt in range(1, PROFILE_TRIES + 1):
        tot, seen = _profiled_us(torch, step, iters, kernel)
        check(kernel is None or tot > 0 or seen == 0,
              f"the profiler saw {seen} device activities but none in a "
              f"kernel named like {kernel!r}")
        if flush is not None and kernel is None:
            tot -= _profiled_us(torch, lambda: flush.add_(1), iters)[0]
        if tot > 0:
            return tot / iters / 1e3
        print(f"note: trace {attempt} of {PROFILE_TRIES} of the call at "
              f"{Path(fn.__code__.co_filename).name}:{fn.__code__.co_firstlineno} "
              f"held no device "
              f"time ({seen} device activities, {tot:.3f} us after the "
              "flush)", file=sys.stderr)
    ms = time_ms(torch, fn, iters, flush, warm)
    print(f"note: that call is timed with CUDA events instead: {ms:.6f} ms",
          file=sys.stderr)
    return ms


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


def credit(torch, fn):
    """(FLOPs, bytes) that the one kernel wrapper ``fn`` calls credits to a
    cost counter (``launch/costs.py``): the kernel's own work, from
    ``kernels/ops.py``'s ``*_work``. ``fn`` runs once."""
    from repro_torch.launch import costs
    with costs.Counter() as c:
        fn()
    (k,) = c.kernels.values()
    return k["flops"], k["bytes"]


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
    flops, moved = credit(torch, lambda: ops.mips_topk(q, x, k, tile))
    # two TF32 products per product of an fp16 store (2xTF32)
    b_ms, b_by = bound(moved, 2 * flops, TF32_FLOPS)
    old_ms, old_by = bound(moved, flops, F32_FLOPS)
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
    flops, moved = credit(torch, lambda: ops.mips_topk_int8(q8, qs, x8, xs,
                                                            k, tile))
    b_ms, b_by = bound(moved, flops, INT8_OPS)
    rows.append(dict(name="mips_topk_int8", route="cuda",
                     source="src/repro_torch/csrc/mips_topk_int8.cu",
                     replaces="src/repro/kernels/mips_topk_int8.py:50",
                     max_abs_err=err8, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib,
                     calls=(call, plain_call, lib_call)))

    # -- B3 ------------------------------------------------------------------
    B, T, Hq, Hkv, Dh, ns = 4, 160, 16, 8, 128, 8

    def b3_case(T_, lengths, dt, ns_, tol, label, D_=Dh, Hq_=Hq, Hkv_=Hkv):
        qq = torch.randn((B, Hq_, D_), generator=g, device=dev)
        kk = torch.randn((B, T_, Hkv_, D_), generator=g, device=dev).to(dt)
        vv = torch.randn((B, T_, Hkv_, D_), generator=g, device=dev).to(dt)
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
    # the dense family's heads (G = 3, 4, 5, 9; D = 64 and 128) over a
    # 160-row cache, ragged lengths: f32 (a session's cache) and bf16 (the
    # batch scheduler's, as phases 8 and 9 serve)
    rag160 = torch.randint(0, 160, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    for arch, h, hk, d in DENSE_HEADS:
        b3_case(T, rag160, torch.float32, ns, TOL_DECODE_F32,
                f"{arch} Hq={h} Hkv={hk} D={d} T=160 f32 cache", d, h, hk)
        b3_case(T, rag160, torch.bfloat16, ns, TOL_DECODE_BF16,
                f"{arch} Hq={h} Hkv={hk} D={d} T=160 bf16 cache", d, h, hk)
    for arch, h, hk, d in FAMILY_HEADS:     # phase 12's GQA decode
        b3_case(T, rag160, torch.float32, ns, TOL_DECODE_F32,
                f"{arch} Hq={h} Hkv={hk} D={d} T=160 f32 cache", d, h, hk)
        b3_case(T, rag160, torch.bfloat16, ns, TOL_DECODE_BF16,
                f"{arch} Hq={h} Hkv={hk} D={d} T=160 bf16 cache", d, h, hk)
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
    def b3_timing(qq, kk, vv, lens, iters):
        """(kernel, plain, library) device ms, their per-call event ms,
        and the bound, for one B3 shape."""
        T_ = kk.shape[1]
        ms_, call_ = timed(torch, lambda: ops.decode_attention(
            qq, kk, vv, lens, ns), iters, None, "decode_attention_kernel")
        plain_, plain_call_ = timed(torch, lambda: da.combine_splits(
            *da.decode_partials_plain(qq, kk, vv, lens, ns)), iters // 4)
        pos = torch.arange(T_, device=dev)
        mask = (pos[None, :] <= lens[:, None])[:, None, None, :]
        qs_ = qq.to(kk.dtype)[:, :, None, :]
        kt, vt = kk.transpose(1, 2), vv.transpose(1, 2)
        lib_, lib_call_ = timed(torch, lambda: F.scaled_dot_product_attention(
            qs_, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        # the attended rows of k and v, read once each
        flops_, moved_ = credit(torch, lambda: ops.decode_attention(
            qq, kk, vv, lens, ns))
        b_ms_, b_by_ = bound(moved_, flops_, F32_FLOPS)
        return ms_, plain_, lib_, (call_, plain_call_, lib_call_), b_ms_, \
            b_by_

    ms, plain, lib, calls, b_ms, b_by = b3_timing(qq, kk, vv, main_len, 200)
    print(f"B3 as gqa_decode calls it (ops.decode_attention, one launch): "
          f"device {spread(ms)} ms, per call with host gaps {calls[0]:.4f} "
          "ms")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="src/repro_torch/csrc/decode_attention.cu",
                     replaces="src/repro/kernels/decode_attention.py:47",
                     max_abs_err=err3, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib, calls=calls))
    # phase 13's shapes: whisper-base's cross-attention decode, one token
    # over the 1500 static encoder rows (8 heads of 64, G = 1, lengths
    # 1499: every frame), and qwen2-vl-72b's decode (64/8 heads of 128,
    # G = 8) over a 160-row cache; f32 (a session's cache) and bf16
    full = torch.full((B,), WHISPER_FRAMES - 1, dtype=torch.int32,
                      device=dev)
    for dt, tol in ((torch.float32, TOL_DECODE_F32),
                    (torch.bfloat16, TOL_DECODE_BF16)):
        b3_case(WHISPER_FRAMES, full, dt, ns, tol,
                f"whisper-base cross-attention B=4 T={WHISPER_FRAMES} "
                f"lengths {WHISPER_FRAMES - 1} {dt}", 64, 8, 8)
        b3_case(T, rag160, dt, ns, tol, f"qwen2-vl-72b Hq=64 Hkv=8 D=128 "
                f"T=160 {dt} cache", 128, 64, 8)
    for label, (T_, h, hk, d, lens) in (
            ("whisper-base cross-attention B=4 T=1500", (
                WHISPER_FRAMES, 8, 8, 64, full)),
            ("qwen2-vl-72b B=4 T=160 lengths 100", (T, 64, 8, 128,
                                                    main_len))):
        for dt in (torch.float32, torch.bfloat16):
            qq = torch.randn((B, h, d), generator=g, device=dev)
            kk, vv = (torch.randn((B, T_, hk, d), generator=g,
                                  device=dev).to(dt) for _ in range(2))
            t = b3_timing(qq, kk, vv, lens, 200)
            print(f"timing decode_attention {label} {dt} cache (device "
                  f"time per call, profiler, median (min-max) of 3): kernel "
                  f"{spread(t[0])} ms, plain {spread(t[1])} ms, library "
                  f"{spread(t[2])} ms, bound {t[4]:.5f} ms ({t[5]}); per "
                  f"call with host gaps (CUDA events): kernel "
                  f"{t[3][0]:.4f}, plain {t[3][1]:.4f}, library "
                  f"{t[3][2]:.4f} ms")
    # -- B4 ------------------------------------------------------------------
    from repro_torch.kernels import flash_attention as fa
    lib_fa = ops._lib("flash_attention")

    def b4_case(shape, causal, dt, label):
        """``shape`` (B, S, T, Hq, Hkv, D[, Dv]): v is Dv wide (MLA's)."""
        B_, S_, T_, Hq_, Hkv_, D_ = shape[:6]
        Dv_ = shape[6] if len(shape) > 6 else D_
        qq, kk, vv = (torch.randn(sh, generator=g, device=dev).to(dt)
                      for sh in ((B_, S_, Hq_, D_), (B_, T_, Hkv_, D_),
                                 (B_, T_, Hkv_, Dv_)))
        got = ops.flash_attention(qq, kk, vv, causal)
        want = fa.flash_attention_plain(qq, kk, vv, causal)
        torch.cuda.synchronize()
        tol = TOL_FLASH_F32 if dt == torch.float32 else TOL_FLASH_BF16
        e = float((got.float() - want.float()).abs().max())
        check(got.dtype == dt and got.shape == want.shape and torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol),
              f"B4 {label}: differs from plain (max {e})")
        print(f"B4 {label}: ok max_abs_err={e:.3e} (tol {tol})")
        return e, (qq, kk, vv)

    def b4_timing(qq, kk, vv, causal, iters, flush_=None):
        """(kernel, plain, library) device ms, their per-call event ms,
        and the bound, for one shape."""
        ms_, call_ = timed(torch, lambda: fa.flash_attention_cuda(
            lib_fa, qq, kk, vv, causal), iters, flush_,
            "flash_attention_kernel")
        plain_, plain_call_ = timed(torch, lambda: fa.flash_attention_plain(
            qq, kk, vv, causal), max(iters // 5, 10), flush_)
        qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
        lib_, lib_call_ = timed(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters, flush_)
        # the (query, key) pairs this call must score: all, or the causal
        # lower triangle; f32 products as 3xTF32
        ops_, moved = credit(torch, lambda: ops.flash_attention(
            qq, kk, vv, causal))
        b_ms_, b_by_ = bound(moved, 3 * ops_, TF32_FLOPS) \
            if qq.dtype == torch.float32 else \
            bound(moved, ops_, BF16_FLOPS)
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
    for arch, h, hk, d in DENSE_HEADS + FAMILY_HEADS:
        b4_case((1, 160, 160, h, hk, d), True, torch.float32,
                f"{arch} prefill S=T=160 Hq={h} Hkv={hk} D={d} f32 causal")
    for dt in (torch.float32, torch.bfloat16):   # phase 11's MLA prefill
        b4_case(MLA_SHAPE, True, dt, "deepseek-v2-lite-16b MLA prefill "
                f"S=T=160 H=16 q/k D=192 v Dv=128 {dt} causal")
    ms, plain, lib, calls, b_ms, b_by = b4_timing(*enc_in, False, 50, flush)
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:65",
                     max_abs_err=err4, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib, calls=calls,
                     shape="(a) B=256 S=T=64 H=6 D=64 f32 non-causal"))
    # phase 13's shapes: whisper-base's encoder (8 heads of 64 over its
    # 1500 frames, non-causal) at batch 1 and 4, its cross-attention
    # prefill (the KB prompt's queries over the 1500 frames), and
    # qwen2-vl-72b's prefill (64/8 heads of 128)
    wf = WHISPER_FRAMES
    new_b4 = [(f"whisper-base encoder B=1 S=T={wf}", (1, wf, wf, 8, 8, 64),
               False),
              (f"whisper-base encoder B=4 S=T={wf}", (4, wf, wf, 8, 8, 64),
               False),
              (f"whisper-base cross-attention prefill B=1 S={prompt_len} "
               f"T={wf}", (1, prompt_len, wf, 8, 8, 64), False),
              (f"whisper-base cross-attention prefill B=4 S={prompt_len} "
               f"T={wf}", (4, prompt_len, wf, 8, 8, 64), False),
              ("qwen2-vl-72b prefill S=T=160 Hq=64 Hkv=8 D=128",
               (1, 160, 160, 64, 8, 128), True)]
    timing_in = [("(b) S=T=160", pre_in, True),
                 (f"(b) S=T={prompt_len}", real_in, True),
                 ("(c) S=T=512", lm_in, True)]
    for label, shape, causal in new_b4:
        for dt in (torch.bfloat16, torch.float32):
            _, ins = b4_case(shape, causal, dt, f"{label} {dt} "
                             f"{'causal' if causal else 'non-causal'}")
        timing_in.append((label, ins, causal))          # the f32 inputs
    for label, (qq, kk, vv), causal in timing_in:
        t = b4_timing(qq, kk, vv, causal, 200 if qq.shape[1] < 1000 else 50)
        print(f"timing flash_attention {label} f32 "
              f"{'causal' if causal else 'non-causal'} (device time per "
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


def decode_rate(torch, engine, prompt, batch, max_new=33):
    """Greedy decode of ``batch`` copies of one prompt (one wave), the
    prefill outside the timed window: generated tokens per second and ms
    per decode step."""
    s = engine.start_batch_session([prompt] * batch, max_new=max_new)
    s.admit()
    torch.cuda.synchronize()
    s.run()
    torch.cuda.synchronize()
    toks = sum(len(r.out_ids) - 1 for r in s.results())
    steps = s.chunks_run * engine.chunk
    return toks / s.decode_s, s.decode_s / steps * 1e3, s.results()


def decode_profile(torch, engine, prompt, batch):
    """One decode chunk (``engine.chunk`` steps at ``batch`` live slots)
    under torch.profiler: wall time, device busy time, the device
    activities that took the most time, and the host-side operators with
    the most self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    s = engine.start_batch_session([prompt] * batch,
                                   max_new=engine.chunk + 1)
    s.admit()                        # prefill outside the window
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
    # None when CUPTI recorded no device activity in the window
    busy = sum(_dev_us(e) for e in dev) / 1e6 or None
    top = [(e.key[:70], _dev_us(e) / 1e3, e.count) for e in dev[:6]]
    host = sorted(ev, key=lambda e: -e.self_cpu_time_total)
    cpu = [(e.key[:70], e.self_cpu_time_total / 1e3, e.count)
           for e in host[:8]]
    ops = sum(e.count for e in ev if e.key.startswith("aten::"))
    launches = sum(e.count for e in ev if e.key.startswith("cudaLaunchKernel"))
    return wall, busy, top, cpu, ops, launches


def busy_text(wall, busy):
    """The device busy time and idle share of a decode_profile window."""
    if busy is None:
        return "device busy and idle share not measured (the trace held no " \
            "device activity)"
    return f"device busy {busy * 1e3:.2f} ms, device idle share " \
        f"{1 - busy / wall:.3f}"


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
        # phase 15 serves the same store before any write-back
        shutil.copytree(work / label, work / f"{label}_mesh")
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
        tps, step_ms, _ = decode_rate(torch, engine, miss_prompt, bsz)
        print(f"decode qwen3-1.7b full width fp32 weights, batch {bsz}: "
              f"{tps:.1f} tokens/s, {step_ms:.2f} ms/step on {card}")
    wall, busy, top, cpu, n_ops, n_launch = decode_profile(
        torch, engine, miss_prompt, 4)
    print(f"decode chunk profile (batch 4, {engine.chunk} steps, profiler "
          f"on): wall {wall * 1e3:.2f} ms, {busy_text(wall, busy)}, "
          f"{n_ops} aten ops, {n_launch} cudaLaunchKernel calls")
    for name, ms, n in top:
        print(f"  device {ms:9.3f} ms  x{n:<5d} {name}")
    for name, ms, n in cpu:
        print(f"  host   {ms:9.3f} ms  x{n:<5d} {name}")
    return counts_all, engine, results


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


# ---------------------------------------------------------------------------
# phases 8-10: the paper's 8B model, the dense family, MiniLM training
# ---------------------------------------------------------------------------


def release(torch):
    """Hand back to the card what dropped objects held."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def gib(n_bytes):
    return n_bytes / 2 ** 30


def param_bytes(params):
    from repro_torch.models.convert import tree_leaves
    ts = list(tree_leaves(params))
    return sum(t.numel() for t in ts), sum(nb(t) for t in ts)


def describe(cfg):
    head = (f"{'tied' if cfg.tie_embeddings else 'untied'} head over "
            f"{cfg.padded_vocab} ids")
    ssm = (f"Mamba2 SSD {cfg.n_ssm_heads} heads of {cfg.ssm_head_dim}, "
           f"state {cfg.ssm_state}, conv {cfg.ssm_conv}")
    if cfg.family == "ssm":
        return f"{cfg.n_layers} layers, d_model {cfg.d_model}, {ssm}, {head}"
    if cfg.use_mla:
        attn = (f"MLA {cfg.n_heads} heads (q/k {cfg.qk_nope_head_dim} + "
                f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}, kv rank "
                f"{cfg.kv_lora_rank})")
    else:
        attn = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} x "
                f"{cfg.resolved_head_dim}")
    if cfg.family == "moe":
        ffn = (f"{cfg.n_experts} experts of {cfg.d_ff_expert} (top "
               f"{cfg.experts_per_tok}"
               f"{f', {cfg.n_shared_experts} shared' if cfg.n_shared_experts else ''}"
               f"){f', {cfg.first_dense_layers} leading dense layer of {cfg.d_ff_dense}' if cfg.first_dense_layers else ''}")
    else:
        ffn = (f"{'gated ' if cfg.gated_mlp else ''}{cfg.mlp_act} MLP "
               f"{cfg.d_ff}")
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {ssm}; one "
                f"shared block ({attn}, {ffn}) before layers 0, {k}, "
                f"{2 * k}, ... ({-(-cfg.n_layers // k)} invocations), {head}")
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {attn}, {head}, "
            f"{ffn}{', QKV bias' if cfg.attn_bias else ''}"
            f"{', qk-norm' if cfg.qk_norm else ''}")


def phase_paper8b(torch, np, args, card, corpus, dev):
    """8: the paper's own serving model, storinfer-paper-8b at full width
    and depth (fp32 random weights from ``--seed``), as the fallback LM
    behind the paper's 150,000-pair fp16 store."""
    return {"paper8b": serve_full_model(
        torch, np, args, card, corpus, dev, PAPER_8B, "slice paper8b",
        ("mips_topk", "decode_attention", "flash_attention"))}


def phase_moe(torch, np, args, card, corpus, dev):
    """11: the moe family behind the store: deepseek-v2-lite-16b (MLA +
    MoE) at full width and depth, fp32 random weights from ``--seed``.
    Its prefill runs MLA's expanded heads on B4; its decode is MLA's
    absorbed attention over the compressed cache, plain PyTorch, so B3
    must show no launch there."""
    return {"moe": serve_full_model(
        torch, np, args, card, corpus, dev, MOE_ARCH, "slice moe",
        ("mips_topk", "flash_attention"), absent={
            "decode_attention": "MLA's absorbed decode (one latent head, "
            "q/k 576 and v 512 wide, past B3's 256) is plain PyTorch, as "
            "it is plain einsums in the reference"})}


def serve_full_model(torch, np, args, card, corpus, dev, arch, label, need,
                     absent=None):
    """``arch`` at full width and depth as the fallback LM behind the
    paper's 150,000-pair fp16 store; phase 4's stream and system (flat
    index, 4 decode slots, write-back), the staged pipeline's queues set
    through ``SystemCfg.queue_depth``: latencies, decode rates, a profiled
    decode chunk, the §4 effective latency beside the analytic H100
    model, peak memory. The kernels in ``need`` must launch on the
    serving run; those in ``absent`` (name -> why) must not."""
    from repro_torch.api import EngineCfg, StorInfer, SystemCfg
    from repro_torch.configs import get_config
    from repro_torch.core import latency
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.core.runtime import BatchedRuntimeCfg
    from repro_torch.launch.serve import write_kb_store

    kb, pairs, tok, stream, exact = corpus
    work = ROOT / "build" / "chip_smoke" / arch
    shutil.rmtree(work, ignore_errors=True)
    ecfg = EngineCfg(arch=arch, smoke=False, max_len=160, chunk=8,
                     seed=args.seed)
    cfg = SystemCfg(index="flat", s_th_run=0.9, decode_slots=4,
                    queue_depth=QUEUE_DEPTH, device=str(dev),
                    batched=BatchedRuntimeCfg(add_misses=True,
                                              rebuild_every=8),
                    engine=ecfg)
    check(cfg.batched.queue_depth == QUEUE_DEPTH,
          f"{label}: SystemCfg.queue_depth did not reach the runtime")
    t0 = time.perf_counter()
    write_kb_store(work, kb, HashEmbedder(), N_STORE, seed=args.seed,
                   emb_dtype="float16").close()
    t_write = time.perf_counter() - t0
    print(f"{label}: device memory held before the build "
          f"{gib(torch.cuda.memory_allocated()):.3f} GiB (earlier phases "
          "released)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    si = StorInfer.open(work, cfg, tokenizer=tok)
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    with si:
        engine = si.engine
        mcfg = engine.cfg
        check(mcfg == get_config(arch),
              f"{label}: the engine is not {arch} at full width and depth")
        n_par, n_bytes = param_bytes(engine.params)
        print(f"{label}: {mcfg.name}: {describe(mcfg)}; "
              f"{n_par / 1e9:.3f} B parameters, {gib(n_bytes):.2f} GiB fp32 "
              f"on {engine.device}; store of {N_STORE} pairs written in "
              f"{t_write:.2f} s, opened (upload + engine init) in "
              f"{t_open:.2f} s")
        _, counts, out, res = serve_slice(torch, np, si, stream, exact,
                                          dict(pairs), label)
        for n in need:
            check(counts[n] > 0, f"{label}: kernel {n} was not launched on "
                  "the main path")
        for n, why in (absent or {}).items():
            check(counts[n] == 0, f"{label}: kernel {n} launched "
                  f"{counts[n]} times where it has no call site")
            print(f"{label}: {n} launched 0 times on this slice, as it must: "
                  f"{why}")
        # a stage's depth counts its bounded queue and what the stage
        # holds: the search stage a microbatch, the others one item
        stages = si.stats().pipeline["stages"]
        held = {"search": cfg.batched.max_batch, "resolve": 1, "decode": 1}
        print(f"{label}: staged pipeline at queue_depth {QUEUE_DEPTH}: "
              "deepest " + ", ".join(f"{k} {v['max_depth']}"
                                     for k, v in stages.items()))
        check(all(stages[k]["max_depth"] <= QUEUE_DEPTH + n
                  for k, n in held.items()),
              f"{label}: a stage queue outgrew queue_depth {QUEUE_DEPTH}")
        misses = [t for t, r in zip(stream, res) if not r.hit]
        for bsz in (1, 4):
            tps, step_ms, _ = decode_rate(torch, engine, misses[0], bsz)
            out[f"decode_b{bsz}_ms_per_step"] = step_ms
            print(f"decode {mcfg.name} fp32 weights, batch {bsz}: "
                  f"{tps:.1f} tokens/s, {step_ms:.2f} ms/step on {card}")
        wall, busy, top, cpu, n_ops, n_launch = decode_profile(
            torch, engine, misses[0], 4)
        print(f"{label}: decode chunk profile (batch 4, {engine.chunk} "
              f"steps, profiler on): wall {wall * 1e3:.2f} ms, "
              f"{busy_text(wall, busy)}, {n_ops} aten ops, {n_launch} "
              "cudaLaunchKernel calls")
        for name, ms, n in top:
            print(f"  device {ms:9.3f} ms  x{n:<5d} {name}")
        hit_rate = out["hits"] / (out["hits"] + out["misses"])
        hit_s, miss_s = out["hit_p50_ms"] / 1e3, out["miss_p50_ms"] / 1e3
        eff = latency.effective_latency(hit_rate, hit_s, miss_s)
        prompt_tokens = int(np.median([len(engine.tok.encode(t, bos=True))
                                       for t in misses]))

        def modeled(n):
            m = latency.llm_latency(latency.H100, n, prompt_tokens, MAX_NEW,
                                    dtype_bytes=4)
            return (f"llm_latency(H100, {n / 1e9:.3f}e9, {prompt_tokens} "
                    f"prompt tokens, {MAX_NEW} out, fp32): prefill "
                    f"{m['prefill_s'] * 1e3:.2f} ms + decode "
                    f"{m['decode_s'] * 1e3:.1f} ms = "
                    f"{m['total_s'] * 1e3:.1f} ms")

        print(f"{label}: §4 effective latency {eff * 1e3:.1f} ms at this "
              f"stream's hit rate {hit_rate:.3f} ({out['hits']} of "
              f"{len(stream)}; a constructed mix of exact, 'hi, '-prefixed "
              "and unanticipated queries, not the paper's Table 1) = "
              f"{hit_rate:.3f} x hit p50 {hit_s * 1e3:.2f} ms + "
              f"{1 - hit_rate:.3f} x miss p50 {miss_s * 1e3:.1f} ms, "
              f"{1 - eff / miss_s:.3f} below the miss p50 at this hit rate; "
              f"analytic model {modeled(n_par)} on {card}")
        if mcfg.family == "moe":
            print(f"{label}: the analytic model at the "
                  f"{mcfg.active_param_count() / 1e9:.3f} B parameters a "
                  f"token routes through, {modeled(mcfg.active_param_count())}"
                  "; it understates this engine, whose decode step reads "
                  f"all {mcfg.n_experts} experts' weights through the "
                  "(E, C, d) dispatch buffer")
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: peak device memory {gib(peak):.3f} GiB on {card}")
        del engine
    del si
    release(torch)
    shutil.rmtree(work, ignore_errors=True)
    return counts


def phase_dense_family(torch, np, args, card, corpus, dev):
    """9: the rest of the dense family at full width: one KB prompt's
    prefill (B4) and ``MAX_NEW`` greedy tokens (B3) at batch 1 and 4."""
    return run_family(torch, np, args, card, corpus, dev, "dense family",
                      [(arch, layers, None) for arch, layers in
                       DENSE_FAMILY])


def phase_families(torch, np, args, card, corpus, dev):
    """12: grok-1-314b (moe with GQA; the layers that fit, at full width),
    mamba2-130m (ssm) and zamba2-1.2b (hybrid) at full width and depth:
    one KB prompt's prefill and ``MAX_NEW`` greedy tokens at batch 1 and
    4. grok-1 and zamba2's shared block attend on B4 and B3; mamba2 has
    no attention and launches no kernel."""
    return run_family(torch, np, args, card, corpus, dev, "families", [
        ("grok-1-314b", GROK_LAYERS, None),
        ("mamba2-130m", None, "mamba2 is attention-free (SSD scan and "
         "recurrent step in plain PyTorch, as in the reference)"),
        ("zamba2-1.2b", None, None)])


def run_family(torch, np, args, card, corpus, dev, phase, archs):
    """Each of ``archs`` ((arch, layers or None for full depth, None or why
    the arch launches no kernel)) at full width, its engine built from
    ``init_model`` and ``Engine`` and released before the next one: one KB
    prompt's prefill and ``MAX_NEW`` greedy tokens at batch 1 and batch 4,
    prefill on B4 and decode on B3 unless the arch has no attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    tok, prompt = corpus[2], corpus[1][0][0]
    out = {}
    for arch, layers, no_kernel in archs:
        label = f"{phase} {arch}"
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        if layers is not None:
            print(f"reduced: {arch} runs {layers} of its {full.n_layers} "
                  f"layers at full width (fp32 weights at full depth are "
                  f"{gib(4 * full.param_count()):.1f} GiB, more than the "
                  f"card's 80 GB; {layers} layers are "
                  f"{gib(4 * cfg.param_count()):.1f} GiB, "
                  f"{layers + 1} would be "
                  f"{gib(4 * dataclasses.replace(full, n_layers=layers + 1).param_count()):.1f})")
        release(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        engine = Engine(cfg, M.init_model(cfg, gen, dtype=torch.float32,
                                          device=dev), tok, max_len=160,
                        chunk=8)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_par, n_bytes = param_bytes(engine.params)
        ids = engine.tok.encode(prompt, bos=True)
        ops.reset_launch_counts()
        logits, _ = engine._prefill(engine.tokens(ids))
        finite = bool(torch.isfinite(logits).all())
        pre_s = median_s(torch, lambda: engine._prefill(engine.tokens(ids)),
                         reps=3)
        rates, ids_out, n_out = [], [], []
        for bsz in (1, 4):
            tps, step_ms, done = decode_rate(torch, engine, prompt, bsz,
                                             max_new=MAX_NEW + 1)
            rates.append(f"batch {bsz}: {tps:.1f} tokens/s, {step_ms:.2f} "
                         "ms/step")
            ids_out += [i for r in done for i in r.out_ids]
            n_out += [len(r.out_ids) for r in done]
            out[f"{arch} b{bsz}"] = step_ms
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: {describe(cfg)}; {n_par / 1e9:.3f} B parameters, "
              f"{gib(n_bytes):.2f} GiB fp32, initialised in {t_init:.2f} s "
              f"({gib(held):.3f} GiB held before); "
              f"prefill of a {len(ids)}-token KB prompt "
              f"{pre_s * 1e3:.2f} ms; {MAX_NEW} greedy tokens, "
              + "; ".join(rates) + f"; peak device memory {gib(peak):.3f} "
              f"GiB on {card}; launches {counts}")
        check(finite, f"{label}: prefill logits are not finite")
        check(all(1 <= n <= MAX_NEW + 1 for n in n_out) and all(
            0 <= i < cfg.padded_vocab for i in ids_out),
            f"{label}: token ids outside the padded vocab, or a request "
            f"without tokens ({n_out})")
        if no_kernel is None:
            check(counts["flash_attention"] > 0 and
                  counts["decode_attention"] > 0,
                  f"{label}: prefill or decode did not run on B4/B3 "
                  f"({counts})")
        else:
            check(not any(counts.values()), f"{label}: launched a kernel "
                  f"({counts}) where it has no call site")
            print(f"{label}: no kernel launched, as it must be: {no_kernel}")
        out[arch] = counts
        del engine, logits
    release(torch)
    return {k: v for k, v in out.items() if isinstance(v, dict)}


def phase_train(torch, np, args, card, corpus, dev):
    """10: MiniLM contrastive training on the card (phase 6's encoder
    config and seed) over the squad KB's paraphrase pairs; the first
    steps' losses against a CPU run from the same weights and draws, a
    copy's update at a large step against the CPU's, and the top-1
    scores of the stream's query groups over the KB's anticipated pairs
    before and after."""
    from repro_torch.core.embedder import MiniLMEncoder
    from repro_torch.core.index import exact_fp32
    from repro_torch.core.kb import render_query
    from repro_torch.kernels import ops
    from repro_torch.models.convert import tree_leaves

    label = "minilm train"
    kb, pairs, tok, stream, exact = corpus
    exact_fp32()
    enc = MiniLMEncoder(tok, seed=args.seed, device=dev)
    p0 = _tree_to(enc.params, "cpu")
    train = [(render_query(f, 0), render_query(f, 2)) for f in kb.facts]
    groups = {"exact": [], "near": [], "unanticipated": []}
    for t in stream:
        groups["exact" if t in exact else "near" if t.startswith("hi, ")
               else "unanticipated"].append(t)
    anticipated = [q for q, _ in pairs]

    def top1():
        x = torch.from_numpy(enc.encode(anticipated)).to(dev)
        return {g: ops.mips_topk(torch.from_numpy(enc.encode(ts)).to(dev),
                                 x, 1)[0][:, 0].cpu().numpy()
                for g, ts in groups.items()}

    ops.reset_launch_counts()
    before = top1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = enc.train_contrastive(train, steps=TRAIN_STEPS, bs=TRAIN_BS,
                                   lr=TRAIN_LR, seed=args.seed)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    after = top1()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_cpu = 3
    t0 = time.perf_counter()
    cpu_losses = MiniLMEncoder(tok, params=_tree_to(p0, "cpu"),
                               device="cpu").train_contrastive(
        train, steps=n_cpu, bs=TRAIN_BS, lr=TRAIN_LR, seed=args.seed)
    t_cpu = (time.perf_counter() - t0) / n_cpu
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"{label}: {TRAIN_STEPS} steps of bs {TRAIN_BS} at lr {TRAIN_LR} "
          f"over {len(train)} paraphrase pairs in {t_train:.2f} s, "
          f"{t_train / TRAIN_STEPS:.4f} s per step on {card} (the CPU: "
          f"{t_cpu:.2f} s per step); loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, mean of the first 10 {first:.5f}, of the last "
          f"10 {last:.5f}; launches {counts}")
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"{label}: the first {n_cpu} steps' losses on the card "
          + " ".join(f"{x:.7f}" for x in losses[:n_cpu]) + ", on the CPU "
          + " ".join(f"{x:.7f}" for x in cpu_losses)
          + f" (largest relative difference {err:.2e}, tol {TOL_TRAIN}, "
          "TF32 off)")
    # the update at a large step: the full-size backward and momentum SGD
    chk = [MiniLMEncoder(tok, params=_tree_to(p0, d), device=d)
           for d in (dev, "cpu")]
    chk_losses = [e.train_contrastive(train, steps=TRAIN_CHECK_STEPS,
                                      bs=TRAIN_BS, lr=TRAIN_CHECK_LR,
                                      seed=args.seed) for e in chk]
    base = list(tree_leaves(p0))
    ups = [[p.cpu() - b for p, b in zip(tree_leaves(e.params), base)]
           for e in chk]
    scale = max(float(u.abs().max()) for u in ups[1])
    diffs = [float((a - b).abs().max()) for a, b in zip(*ups)]
    up_err = max(diffs) / scale
    leaf_err = max(d / max(float(u.abs().max()), 1e-30)
                   for d, u in zip(diffs, ups[1]))
    chk_err = max(abs(a - b) / abs(b) for a, b in zip(*chk_losses))
    print(f"{label}: a copy's {TRAIN_CHECK_STEPS} steps at lr "
          f"{TRAIN_CHECK_LR:g}, card vs CPU: largest update {scale:.4f}, "
          f"updates differ by {up_err:.2e} of it (tol {TOL_TRAIN_UPDATE}; "
          f"worst leaf {leaf_err:.2e} of its own largest), losses by "
          f"{chk_err:.2e} relative (tol {TOL_TRAIN})")
    for name, sc in (("before", before), ("after", after)):
        for g, v in sc.items():
            print(f"{label}: top-1 scores {name} training, {g} "
                  f"({len(v)}) over the {len(anticipated)} anticipated "
                  "pairs: min/p10/p50/p90/max " + " ".join(
                      f"{x:.6f}" for x in np.percentile(v, [0, 10, 50, 90,
                                                            100])))
        stored = np.concatenate([sc["exact"], sc["near"]])
        print(f"{label}: {name} training, lowest stored-query score "
              f"{stored.min():.6f} vs highest unanticipated "
              f"{sc['unanticipated'].max():.6f}: "
              + ("separable" if stored.min() > sc["unanticipated"].max()
                 else "overlapping"))
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          f"{label}: a loss is not finite")
    check(last < first, f"{label}: the loss did not fall ({first} -> "
          f"{last})")
    check(err <= TOL_TRAIN, f"{label}: the first steps' losses differ from "
          f"the CPU's by {err:.2e} relative")
    check(up_err <= TOL_TRAIN_UPDATE and chk_err <= TOL_TRAIN,
          f"{label}: the update at lr {TRAIN_CHECK_LR:g} differs from the "
          f"CPU's by {up_err:.2e} of the largest (losses {chk_err:.2e})")
    del enc, chk
    release(torch)
    return {"minilm train": counts}


# ---------------------------------------------------------------------------
# phase 13: the encdec and vlm families through the model API
# ---------------------------------------------------------------------------


def mrope_layout(n_text, grid, n_suffix):
    """(3, S) Qwen2-VL M-RoPE positions: a text prefix (t = h = w = i), a
    grid x grid image block at the next position (t fixed, h the row, w
    the column), then text from the largest position + 1."""
    pos = [[i, i, i] for i in range(n_text)]
    pos += [[n_text, n_text + r, n_text + c] for r in range(grid)
            for c in range(grid)]
    nxt = max(max(p) for p in pos) + 1
    pos += [[nxt + i] * 3 for i in range(n_suffix)]
    return pos


def greedy_api(torch, cfg, params, tokens, kw, n, max_len, mrope_next=None):
    """Prefill (B, S) ``tokens`` through ``prefill`` with the family's
    inputs ``kw``, then ``n`` greedy ``decode_step``s (qwen2-vl: at the
    M-RoPE positions after ``mrope_next``). Returns (the prefill's last
    logits, the (B, n + 1) greedy ids, the decode steps' logits' finiteness,
    prefill s, s per decode step)."""
    from repro_torch.models import model as M
    B, S = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, dict(kw, tokens=tokens),
                              max_len=max_len)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    ids, finite = [logits[:, -1].argmax(-1)], bool(
        torch.isfinite(logits).all())
    t0 = time.perf_counter()
    for t in range(n):
        step_kw = {}
        if mrope_next is not None:
            step_kw["mrope_positions"] = torch.full(
                (3, B, 1), mrope_next + t, dtype=torch.long,
                device=tokens.device)
        lg, cache = M.decode_step(cfg, params, ids[-1][:, None], cache,
                                  S + t, **step_kw)
        finite = finite and bool(torch.isfinite(lg).all())
        ids.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n
    return logits, torch.stack(ids, 1), finite, t_pre, t_dec


def phase_encdec_vlm(torch, np, args, card, corpus, dev):
    """13: whisper-base (encdec) at full size and qwen2-vl-72b (vlm,
    M-RoPE) at full width with ``VLM_LAYERS`` of its 80 layers, through
    the model API (``init_model``, ``prefill``, ``decode_step``: the
    reference's engine prefills tokens only, so neither family is served
    behind the store). Whisper's frames are the stub frontend's random
    (B, 1500, 512) embeddings from ``--seed``; qwen2-vl's prompt is a KB
    text prefix, a 4 x 4 "image" block and a text suffix, numbered as
    Qwen2-VL numbers them. A KB prompt's prefill and ``MAX_NEW`` greedy
    tokens at batch 1 and 4: encoder (whisper), prefill and decode times,
    peak memory, and the B3 and B4 launches of the run, both above 0."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    tok, prompt = corpus[2], corpus[1][0][0]
    ids = tok.encode(prompt, bos=True)
    out = {}
    for arch, layers in (("whisper-base", None), ("qwen2-vl-72b",
                                                   VLM_LAYERS)):
        label = f"encdec + vlm {arch}"
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        if layers is not None:
            more = dataclasses.replace(full, n_layers=layers + 4)
            print(f"reduced: {arch} runs {layers} of its {full.n_layers} "
                  f"layers at full width (fp32 weights at full depth are "
                  f"{gib(4 * full.param_count()):.1f} GiB, more than the "
                  f"card's 80 GB; {layers} layers are "
                  f"{gib(4 * cfg.param_count()):.1f} GiB, {layers + 4} "
                  f"would be {gib(4 * more.param_count()):.1f} and leave "
                  "too little for the cache and the logits)")
        release(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = M.init_model(cfg, gen, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_par, n_bytes = param_bytes(params)
        if cfg.is_encoder_decoder:
            prompt_ids, mrope_next = ids, None
            frames = torch.randn((4, cfg.encoder_seq, cfg.d_model),
                                 generator=gen, device=dev)
        else:
            img = torch.randint(4, tok.vocab_size, (16,), generator=gen,
                                device=dev).tolist()
            prompt_ids = ids[:4] + img + ids[4:]
            pos = mrope_layout(4, 4, len(ids) - 4)
            mrope_next = max(max(p) for p in pos) + 1
        S = len(prompt_ids)
        ops.reset_launch_counts()
        rates, finite, ok_ids, reads = [], True, True, {}
        for bsz in (1, 4):
            tokens = torch.tensor([prompt_ids] * bsz, device=dev)
            kw = {"frames": frames[:bsz]} if cfg.is_encoder_decoder else \
                {"mrope_positions": torch.tensor(pos, device=dev).T[
                    :, None, :].expand(3, bsz, S).contiguous()}
            greedy_api(torch, cfg, params, tokens, kw, 2, 160, mrope_next)
            logits, gen_ids, fin, t_pre, t_dec = greedy_api(
                torch, cfg, params, tokens, kw, MAX_NEW, 160, mrope_next)
            finite = finite and fin
            ok_ids = ok_ids and bool(((gen_ids >= 0) & (
                gen_ids < cfg.vocab_size)).all())
            if cfg.is_encoder_decoder:
                enc_s = median_s(torch, lambda: M._encode(
                    cfg, params, frames[:bsz]), reps=5)
                reads[f"encoder_b{bsz}_ms"] = enc_s * 1e3
            reads[f"prefill_b{bsz}_ms"] = t_pre * 1e3
            reads[f"decode_b{bsz}_ms_per_step"] = t_dec * 1e3
            rates.append(f"batch {bsz}: " + (
                f"encoder {enc_s * 1e3:.2f} ms, " if cfg.is_encoder_decoder
                else "") + f"prefill of {S} tokens {t_pre * 1e3:.2f} ms, "
                f"{MAX_NEW} greedy tokens at {t_dec * 1e3:.2f} ms/step "
                f"({bsz / t_dec:.1f} tokens/s)")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: {describe(cfg)}"
              + (f", {cfg.n_encoder_layers} encoder layers over "
                 f"{cfg.encoder_seq} frames" if cfg.is_encoder_decoder
                 else f", M-RoPE sections {cfg.mrope_sections}")
              + f"; {n_par / 1e9:.3f} B parameters, {gib(n_bytes):.2f} GiB "
              f"fp32, initialised in {t_init:.2f} s ({gib(held):.3f} GiB "
              "held before); " + "; ".join(rates) + f"; peak device memory "
              f"{gib(peak):.3f} GiB on {card}; launches {counts}")
        print(f"{label}: readings " + json.dumps(
            {k: round(v, 4) for k, v in reads.items()}))
        check(finite, f"{label}: logits are not finite")
        check(ok_ids, f"{label}: a greedy id outside the vocab")
        check(counts["flash_attention"] > 0 and
              counts["decode_attention"] > 0,
              f"{label}: prefill or decode did not run on B4/B3 ({counts})")
        out[arch] = counts
        del params
    release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 14: training qwen3-1.7b on the card
# ---------------------------------------------------------------------------


def _clone(torch, tree):
    from repro_torch.models.convert import tree_map
    return tree_map(lambda t: t.clone(), tree)


def phase_train_lm(torch, np, args, card, corpus, dev):
    """14: qwen3-1.7b at full width and depth in the reference's mixed
    precision (bf16 params, f32 AdamW master, m and v), on ``TextFileData``
    over the KB at ``LM_BATCH`` x ``LM_SEQ`` tokens, blockwise attention
    with its hand-written backward. The loss on one repeated batch must
    fall; accum 2 against accum 1 on one batch; s per step and tokens/s;
    a checkpoint saved, restored and stepped, bit for bit the
    uninterrupted step; one compressed step. B4 must show 0 launches: it
    has no backward."""
    from repro_torch.configs import get_config
    from repro_torch.core.index import exact_fp32
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import compression as GC
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T

    label = "train"
    kb, tok = corpus[0], corpus[2]
    exact_fp32()
    cfg = get_config(LM_TRAIN_ARCH)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p0 = M.init_model(cfg, gen, dtype=torch.bfloat16, device=dev)
    n_par, n_bytes = param_bytes(p0)
    data = D.TextFileData([d.text() for d in kb.docs], tok, LM_BATCH, LM_SEQ,
                          seed=args.seed)

    def batch(i):
        return {k: torch.from_numpy(v).long().to(dev)
                for k, v in data.batch(i).items()}

    run = M.RunCfg(attn_impl="blockwise", remat=False)
    ocfg = O.AdamWCfg()
    tol_master = 2 * O.lr_at(ocfg, 1) + 1e-6
    print(f"{label}: {cfg.name}: {describe(cfg)}; {n_par / 1e9:.3f} B "
          f"parameters, {gib(n_bytes):.2f} GiB bf16, AdamW state "
          f"{gib(3 * 4 * n_par):.2f} GiB f32; {len(data.ids)} KB tokens, "
          f"batch {LM_BATCH} x {LM_SEQ}, lr {ocfg.lr} after "
          f"{ocfg.warmup_steps} warmup steps, blockwise attention (q_block "
          f"{run.q_block}, kv_block {run.kv_block})")

    # accum 2 against accum 1: one step from the same fresh state
    res = {}
    for accum in (1, 2):
        p = _clone(torch, p0)
        o = O.init(p)
        p, o, m = T.make_train_step(cfg, run, ocfg, accum=accum)(p, o,
                                                                 batch(0))
        res[accum] = (float(m["loss"]), float(m["grad_norm"]),
                      [t.cpu() for t in tree_leaves(o["master"])])
        del p, o
        release(torch)
    d_master = max(float((a - b).abs().max())
                   for a, b in zip(res[1][2], res[2][2]))
    d_loss = abs(res[1][0] - res[2][0]) / abs(res[1][0])
    d_norm = abs(res[1][1] - res[2][1]) / res[1][1]
    print(f"{label}: accum 2 against accum 1 on one batch, one step: loss "
          f"{res[2][0]:.6f} vs {res[1][0]:.6f} ({d_loss:.2e} relative, tol "
          f"{TOL_ACCUM_LOSS}), grad norm {res[2][1]:.5f} vs {res[1][1]:.5f} "
          f"({d_norm:.2e}, tol {TOL_ACCUM_NORM}), f32 masters differ by "
          f"{d_master:.2e} at most (tol {tol_master:.4g}: 2 lr)")
    del res

    # the loss on one repeated batch
    step = T.make_train_step(cfg, run, ocfg)
    p, o = _clone(torch, p0), O.init(p0)
    del p0
    b0 = batch(0)
    losses = []
    for _ in range(LM_REPEAT):
        p, o, m = step(p, o, b0)
        losses.append(float(m["loss"]))
    print(f"{label}: loss on one repeated batch over {LM_REPEAT} steps: "
          + " ".join(f"{x:.4f}" for x in losses))

    # s per step over fresh batches
    times = []
    for i in range(1, LM_TIMED + 1):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s_step = float(np.median(times))
    print(f"{label}: {LM_TIMED} steps over fresh batches: median "
          f"{s_step:.4f} s per step (min {min(times):.4f}, max "
          f"{max(times):.4f}), {LM_BATCH * LM_SEQ / s_step:.0f} tokens/s; "
          f"last loss {float(m['loss']):.4f} on {card}")

    # a checkpoint: saved, then the uninterrupted step; restored, stepped
    # (phase 16 restores it onto a mesh, phase 17 onto two pods' meshes,
    # then removes it)
    work = TRAIN_CKPT
    shutil.rmtree(work, ignore_errors=True)
    ck = CK.Checkpointer(work)
    nxt = batch(LM_TIMED + 1)
    t0 = time.perf_counter()
    ck.save(int(o["step"]), {"params": p, "opt": o})
    t_copy = time.perf_counter() - t0
    p, o, m = step(p, o, nxt)
    want = [t.cpu() for t in tree_leaves(p)]
    want_loss = float(m["loss"])
    t0 = time.perf_counter()
    ck.wait()
    t_write = time.perf_counter() - t0
    o_grad_err = GC.init_error_state(p)
    del p, o
    release(torch)
    t0 = time.perf_counter()
    st, meta = ck.restore(device=dev)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    p, o = st["params"], st["opt"]
    o["step"] = o["step"].cpu()
    p, o, m = step(p, o, nxt)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(want,
                                                       tree_leaves(p)))
    disk = sum(f.stat().st_size for f in work.rglob("*.npy"))
    print(f"{label}: checkpoint of step {meta['step']}: {len(meta['keys'])} "
          f"arrays, {disk / 1e9:.2f} GB on disk; host copy {t_copy:.2f} s, "
          f"background write done {t_write:.2f} s after the next step, "
          f"restore to the card {t_restore:.2f} s; the step after the "
          f"restore {'equals' if same else 'DIFFERS FROM'} the "
          f"uninterrupted one bit for bit (loss {float(m['loss']):.6f} vs "
          f"{want_loss:.6f})")
    del want

    # one compressed step
    def compress(grads, opt_state):
        dq, err = GC.compress_grads(grads, opt_state["grad_err"])
        return dq, dict(opt_state, grad_err=err)

    o["grad_err"] = o_grad_err
    p, o, mc = T.make_train_step(cfg, run, ocfg, compress=compress)(
        p, o, batch(LM_TIMED + 2))
    err_norm = float(O.global_norm(o["grad_err"]))
    print(f"{label}: one --compress step (int8 codes, error feedback): "
          f"loss {float(mc['loss']):.4f}, grad norm "
          f"{float(mc['grad_norm']):.4f}, residual norm {err_norm:.4e}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: peak device memory {gib(peak):.3f} GiB on {card}; "
          f"launches {counts}: flash_attention 0, as it must be: B4 has no "
          "backward in either package, so training runs the blockwise "
          "attention of models/blockwise.py (plain PyTorch with its "
          "hand-written flash backward), and it decodes nothing")
    print(f"{label}: readings " + json.dumps({
        "s_per_step": round(s_step, 4),
        "tokens_per_s": round(LM_BATCH * LM_SEQ / s_step, 1),
        "peak_gib": round(gib(peak), 3)}))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss on a repeated batch did not fall ({losses})")
    check(d_loss <= TOL_ACCUM_LOSS and d_norm <= TOL_ACCUM_NORM and
          d_master <= tol_master, f"{label}: accum 2 differs from "
          f"accum 1 (loss {d_loss:.2e}, norm {d_norm:.2e}, masters "
          f"{d_master:.2e})")
    check(same, f"{label}: the step after a restore differs from the "
          "uninterrupted step")
    check(np.isfinite(float(mc["loss"])) and np.isfinite(err_norm),
          f"{label}: the compressed step is not finite")
    check(counts["flash_attention"] == 0, f"{label}: B4 launched "
          f"{counts['flash_attention']} times under autograd")
    del p, o, st
    release(torch)
    return {"train lm": counts}


# ---------------------------------------------------------------------------
# phase 15: the mesh paths on four shards of the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4              # the model axis of phase 15's (1, 4) mesh
# (b): the one-device decode runs B3, the seq-sharded one the naive math;
# the two differ by B3's rounding (ROADMAP C, "B3 rounding") over 28 layers
TOL_MESH_DECODE = 1e-2
TOL_MESH = 1e-4              # (c) MLA and (d) expert-parallel MoE, f32
MESH_MOE_TOKENS = 48         # (d): batch 4 x 48 tokens of KB prompts


def phase_mesh(torch, np, args, card, corpus, engine, dev, slices):
    """15: the serving paths over a device mesh, on a (data 1, model 4)
    mesh whose four shards all lie on the one card: (a) the sharded index
    tier that ``StorInfer.open(..., mesh=)`` picks at the paper's store
    size, serving phase 4's fp16 store and stream with the §3.1 rebuild
    (the same hits and responses as phase 4's flat slice, B1 once a shard
    per search), then phase 5's int8 store; (b) qwen3-1.7b (phase 4's
    weights) decoding 16 greedy tokens at batch 4 with the seq-sharded
    decode attention against the one-device decode (B3); (c) one MLA layer
    at deepseek-v2-lite-16b's widths, seq-sharded against one device; (d)
    one MoE layer at deepseek's widths, expert-parallel against the
    scatter dispatch."""
    import dataclasses

    from repro_torch.api import StorInfer, SystemCfg, make_index, tier_of
    from repro_torch.configs import get_config
    from repro_torch.core.index import ShardedIndex
    from repro_torch.core.runtime import BatchedRuntimeCfg
    from repro_torch.distributed.moe_parallel import moe_ffn_ep
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mla as Mla
    from repro_torch.models import model as M
    from repro_torch.models import moe as Moe

    kb, pairs, tok, stream, exact = corpus
    work = ROOT / "build" / "chip_smoke"
    mesh = make_mesh((1, MESH_SHARDS), ("data", "model"),
                     devices=[dev] * MESH_SHARDS)
    print(f"reduced: mesh (data 1, model {MESH_SHARDS}) with every shard on "
          f"{dev} of one card ({card}): the sharded code runs in full, no "
          "byte crosses between cards")
    counts_all = {}

    # -- (a) the sharded tier behind the facade ------------------------------
    searches = [0]
    search = ShardedIndex.search

    def counted(self, queries, k):
        searches[0] += 1
        return search(self, queries, k)

    cfg = SystemCfg(s_th_run=0.9, decode_slots=4, device=str(dev),
                    batched=BatchedRuntimeCfg(add_misses=True,
                                              rebuild_every=8))
    ShardedIndex.search = counted
    try:
        for label in ("fp16", "int8"):
            name = f"mesh {label}"
            t0 = time.perf_counter()
            si = StorInfer.open(work / f"{label}_mesh", cfg, tokenizer=tok,
                                engine=engine, mesh=mesh)
            torch.cuda.synchronize()
            t_open = time.perf_counter() - t0
            with si:
                idx = si.index
                check(tier_of(idx) == "sharded" and len(idx) == N_STORE,
                      f"{name}: StorInfer.open(mesh=) picked "
                      f"{tier_of(idx)!r} over {len(idx)} rows")
                check(all(t.device.type == "cuda"
                          for t in idx.embs.shards.flat),
                      f"{name}: a shard is not on the card")
                sh = idx.embs.shards.flat[0]
                print(f"{name}: index tier 'sharded' (index='auto', "
                      f"{N_STORE} rows >= SHARD_MIN_ROWS), {MESH_SHARDS} "
                      f"shards of {tuple(sh.shape)} {sh.dtype}, opened in "
                      f"{t_open:.2f} s")
                q = si.embedder.encode(stream)
                flat = make_index("flat", si.store, device=str(dev))
                sv, sid = idx.search(q, 1)
                fv, fid = flat.search(q, 1)
                if label == "fp16":
                    err = float(np.abs(sv - fv).max())
                    check(np.array_equal(sid, fid) and err <= TOL_F32,
                          f"{name}: top-1 differs from the flat tier's (ids "
                          f"equal {np.array_equal(sid, fid)}, score error "
                          f"{err:.2e})")
                    print(f"{name}: top-1 of {len(q)} stream queries equal "
                          f"to the flat tier's (B1), scores within {err:.2e}")
                else:
                    vals, sc = si.store.embeddings().take_q(
                        np.arange(N_STORE))
                    plain = torch.from_numpy(q).to(dev) @ (
                        torch.from_numpy(vals).to(dev).float()
                        * torch.from_numpy(sc).to(dev)[:, None]).T
                    pid = plain.argmax(-1).cpu().numpy()
                    agree = float(np.mean(sid[:, 0] == fid[:, 0]))
                    check(np.array_equal(sid[:, 0], pid),
                          f"{name}: top-1 differs from the plain f32 x "
                          "dequantized int8 scan on the card")
                    check(agree >= 0.99, f"{name}: top-1 agrees with the "
                          f"flat tier's B2 on only {agree:.3f}")
                    print(f"{name}: top-1 of {len(q)} stream queries equal "
                          "to the plain f32 x dequantized int8 scan, agree "
                          f"with the flat tier's B2 on {agree:.3f}")
                t_sh = median_s(torch, lambda: idx.search(q, 1), 20) * 1e3
                t_fl = median_s(torch, lambda: flat.search(q, 1), 20) * 1e3
                d_sh = device_ms(torch, lambda: idx.search(q, 1), 20)
                d_fl = device_ms(torch, lambda: flat.search(q, 1), 20)
                print(f"{name}: search of {len(q)} queries, k 1: sharded "
                      f"{t_sh:.3f} ms a call ({d_sh:.4f} ms device), flat "
                      f"{t_fl:.3f} ms ({d_fl:.4f} ms device) on {card}")
                del flat
                searches[0] = 0
                res, counts, out, _ = serve_slice(torch, np, si, stream,
                                                  exact, dict(pairs), name)
                counts_all[name] = counts
                check(tier_of(si._batched.index) == "sharded",
                      f"{name}: the §3.1 rebuild came back "
                      f"{tier_of(si._batched.index)!r}")
                b1 = MESH_SHARDS * searches[0] if label == "fp16" else 0
                check(searches[0] > 0 and counts["mips_topk"] == b1
                      and counts["mips_topk_int8"] == 0,
                      f"{name}: B1 launched {counts['mips_topk']} times in "
                      f"{searches[0]} searches (want {b1}), B2 "
                      f"{counts['mips_topk_int8']}")
                for n in ("decode_attention", "flash_attention"):
                    check(counts[n] > 0, f"{name}: kernel {n} was not "
                          "launched on the main path")
                ref_res, ref_out = slices[label]
                same = [a == b for a, b in zip(res, ref_res)]
                if label == "fp16":
                    check(all(same), f"{name}: hits or stored responses "
                          f"differ from phase 4's flat slice on "
                          f"{same.count(False)} of {len(same)} queries")
                else:
                    check(np.mean(same) >= 0.99, f"{name}: hits agree with "
                          f"phase 5's on only {np.mean(same):.3f}")
                print(f"{name}: {searches[0]} searches, B1 "
                      f"{counts['mips_topk']} launches; hits and responses "
                      f"equal to phase {4 if label == 'fp16' else 5}'s on "
                      f"{np.mean(same):.3f} of {len(same)} queries; rebuilt "
                      f"{out['rebuilds']} time(s) as 'sharded'; hit p50 / "
                      f"p99 {out['hit_p50_ms']:.3f} / {out['hit_p99_ms']:.3f}"
                      f" ms (phase {4 if label == 'fp16' else 5}: "
                      f"{ref_out['hit_p50_ms']:.3f} / "
                      f"{ref_out['hit_p99_ms']:.3f}), miss p50 "
                      f"{out['miss_p50_ms']:.1f} ms "
                      f"({ref_out['miss_p50_ms']:.1f}) on {card}")
            del si
            shutil.rmtree(work / f"{label}_mesh", ignore_errors=True)
    finally:
        ShardedIndex.search = search
    release(torch)

    # -- (b) seq-sharded decode, qwen3-1.7b at full width and depth ----------
    mcfg, params = engine.cfg, engine.params
    miss = next(t for t in stream if t not in exact
                and not t.startswith("hi, "))
    ids = engine.tok.encode(miss, bos=True)
    tokens = torch.tensor([ids] * 4, device=dev)
    S, max_len = tokens.shape[1], 160
    seq = M.KERNEL.replace(decode_attn="seq_sharded", mesh=mesh)

    def greedy(run):
        lg, cache = M.prefill(mcfg, params, tokens, run, max_len=max_len)
        out_ids, logits = [lg[:, -1].argmax(-1)], [lg[:, -1]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MAX_NEW):
            lg, cache = M.decode_step(mcfg, params, out_ids[-1][:, None],
                                      cache, S + t, run)
            out_ids.append(lg[:, -1].argmax(-1))
            logits.append(lg[:, -1])
        torch.cuda.synchronize()
        return (torch.stack(out_ids, 1), torch.stack(logits, 1),
                (time.perf_counter() - t0) / MAX_NEW * 1e3, cache)

    ops.reset_launch_counts()
    one_ids, one_lg, one_ms, _ = greedy(M.KERNEL)
    one_counts = ops.launch_counts()
    ops.reset_launch_counts()
    sh_ids, sh_lg, sh_ms, cache = greedy(seq)
    counts = ops.launch_counts()
    counts_all["mesh decode"] = counts
    check(type(cache["k"]).__name__ == "Sharded"
          and cache["k"].shards.flat[0].shape[2] == max_len // MESH_SHARDS,
          "mesh decode: the cache is not split over the shards")
    check(counts["flash_attention"] == mcfg.n_layers
          and counts["decode_attention"] == 0
          and one_counts["decode_attention"] == MAX_NEW * mcfg.n_layers,
          f"mesh decode: launches {counts} (one device {one_counts}): the "
          "prefill runs B4, the seq-sharded decode no B3")
    gap = float((sh_lg - one_lg).abs().max())
    check(torch.equal(sh_ids, one_ids), "mesh decode: the seq-sharded "
          "greedy tokens differ from the one-device decode's")
    check(gap <= TOL_MESH_DECODE, f"mesh decode: logits differ by {gap:.3e}")
    print(f"mesh decode {mcfg.name} full width and depth, batch 4, f32 cache "
          f"of {max_len} rows ({max_len // MESH_SHARDS} a shard), "
          f"{MAX_NEW} greedy tokens: identical to the one-device decode, max "
          f"logit difference {gap:.3e}; {sh_ms:.2f} ms per step seq-sharded, "
          f"{one_ms:.2f} one device (B3) on {card}")
    del cache
    release(torch)

    # -- (c) MLA seq-sharded, one layer at deepseek-v2-lite's widths ---------
    dcfg = get_config(MOE_ARCH)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    p = Mla.mla_init(g, dcfg, torch.float32, dev)
    x = torch.randn((4, 1, dcfg.d_model), generator=g, device=dev)
    caches = [torch.randn((4, max_len, r), generator=g, device=dev)
              for r in (dcfg.kv_lora_rank, dcfg.qk_rope_head_dim)]
    mla_seq = M.RunCfg(decode_attn="seq_sharded", mesh=mesh)
    sharded = [shard(c, (None, "model"), mesh) for c in caches]
    want = M.mla_decode(dcfg, p, x, *caches, 100)
    got = M.mla_decode(dcfg, p, x, *sharded, 100, run=mla_seq)
    err = float((got - want).abs().max())
    check(err <= TOL_MESH and all(torch.equal(s.full(), c)
                                  for s, c in zip(sharded, caches)),
          f"mesh mla: seq-sharded output differs by {err:.3e}, or a cache")
    t_one = median_s(torch, lambda: M.mla_decode(dcfg, p, x, *caches, 100),
                     20) * 1e3
    t_seq = median_s(torch, lambda: M.mla_decode(dcfg, p, x, *sharded, 100,
                                                 run=mla_seq), 20) * 1e3
    print(f"mesh mla: one layer at {dcfg.name}'s widths ({dcfg.n_heads} "
          f"heads, rank {dcfg.kv_lora_rank}, rope {dcfg.qk_rope_head_dim}), "
          f"B 4, M {max_len}, cache_len 100: seq-sharded within {err:.3e} "
          f"of one device; {t_seq:.3f} ms a call, one device {t_one:.3f} "
          f"on {card}")
    del p, caches, sharded
    release(torch)

    # -- (d) expert parallel, one MoE layer at deepseek-v2-lite's widths -----
    p = Moe.moe_init(g, dcfg, torch.float32, dev)
    wide = dataclasses.replace(dcfg, moe_capacity_factor=64.0)
    emb = torch.randn((engine.tok.vocab_size, dcfg.d_model), generator=g,
                      device=dev) * dcfg.d_model ** -0.5
    rows = []
    for t in [t for t in stream if t not in exact][:4]:
        tid = engine.tok.encode(t, bos=True)
        rows.append((tid * -(-MESH_MOE_TOKENS // len(tid)))[:MESH_MOE_TOKENS])
    x = emb[torch.tensor(rows, device=dev)]                   # (4, 48, d)
    pe = dict(p, experts={n: shard(w, ("model",), mesh)
                          for n, w in p["experts"].items()})
    y, aux = moe_ffn_ep(wide, pe, x, mesh=mesh)
    y0, aux0 = Moe.moe_ffn(wide, p, x, with_aux=True)
    err = float((y - y0).abs().max())
    rel = float(abs(aux - aux0) / abs(aux0))
    check(err <= TOL_MESH and rel <= TOL_MESH, f"mesh ep: y differs by "
          f"{err:.3e}, aux by {rel:.3e} relative")

    def drops(c, x2d):
        _, idx_, _ = Moe.route(c, p, x2d)
        return int((~Moe.dispatch_slots(c, idx_, x2d.shape[0])[1]).sum())

    q_len = MESH_MOE_TOKENS // MESH_SHARDS
    d_scatter = drops(dcfg, x.reshape(-1, dcfg.d_model))
    d_ep = sum(drops(dcfg, x[:, j * q_len:(j + 1) * q_len].reshape(
        -1, dcfg.d_model)) for j in range(MESH_SHARDS))
    t_ep = median_s(torch, lambda: moe_ffn_ep(dcfg, pe, x, mesh=mesh),
                    10) * 1e3
    t_sc = median_s(torch, lambda: Moe.moe_ffn(dcfg, p, x), 10) * 1e3
    n_bytes = sum(nb(w) for w in p["experts"].values())
    print(f"mesh ep: one MoE layer at {dcfg.name}'s widths ({dcfg.n_experts}"
          f" experts top {dcfg.experts_per_tok} + {dcfg.n_shared_experts} "
          f"shared, d {dcfg.d_model}, expert d_ff {dcfg.d_ff_expert}; "
          f"{dcfg.n_experts // MESH_SHARDS} experts a shard), x 4 x "
          f"{MESH_MOE_TOKENS} KB-prompt tokens: at capacity factor 64 y "
          f"within {err:.3e} of the scatter dispatch, aux {rel:.3e} "
          f"relative; at the config's {dcfg.moe_capacity_factor} "
          f"assignments dropped {d_ep} (per shard) vs {d_scatter} (one "
          f"device); {t_ep:.3f} ms a call expert-parallel, {t_sc:.3f} "
          f"scatter, bound {n_bytes / HBM_BYTES_S * 1e3:.3f} ms "
          f"({n_bytes / 1e9:.2f} GB of expert weights) on {card}")
    del p, pe, emb, x
    release(torch)
    return counts_all


# ---------------------------------------------------------------------------
# phase 16: training on a mesh of four shards of the one card
# ---------------------------------------------------------------------------

MESH_TRAIN = (2, 2)          # (data, model): 16 q and 8 kv heads split in 2
MESH_TRAIN_B = (1, 4)        # (d): the mesh the checkpoint moves to
MESH_TRAIN_STEPS = 3
# (b) the mesh step against one device's from the same bf16 state: every
# row-parallel product (wo, w2) rounds its two partial sums to bf16 before
# the psum, one more rounding of 2^-8 relative on each, the same order as
# the two half-batches' bf16 rounding of phase 14's accum 2 against 1
TOL_MESH_TRAIN_LOSS, TOL_MESH_TRAIN_NORM = TOL_ACCUM_LOSS, TOL_ACCUM_NORM


def _leaves_equal(torch, a, b):
    """Whether two state trees (``Sharded`` leaves gathered one at a time
    on the card) hold the same values bit for bit."""
    from repro_torch.distributed.sharding import gather
    from repro_torch.models.convert import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = gather(x), gather(y)
        if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
            return False
    return True


def step_profile(torch, step):
    """(wall s, device busy s or None) of one ``step()`` under
    torch.profiler (CPU and CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(_dev_us(e) for e in ev if _dev_us(e) > 0 and
               e.self_cpu_time_total == 0) / 1e6 or None
    return wall, busy, out


def phase_mesh_train(torch, np, args, card, corpus, dev):
    """16: phase 14's qwen3-1.7b training state (bf16 params, f32 AdamW)
    on a (data 2, model 2) mesh whose four shards share the card, with
    ``make_runcfg``'s layout (q and kv heads and the MLP split over model,
    FSDP over data, vocab-split logits, remat): (a) phase 14's last
    checkpoint restored onto the mesh, every leaf equal to one device's
    restore of it (phase 14's state) bit for bit; (b) one mesh step and
    one one-device step from that state on the same batch, loss and grad
    norm within the stated tolerance; (c) three more mesh steps on that
    batch, the loss falling: s per step, tokens/s, peak memory, the
    device idle share of one profiled step; (d) the mesh's checkpoint
    restored onto (data 1, model 4) bit for bit and stepped there; (e)
    neither B3 nor B4 launched."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.index import exact_fp32
    from repro_torch.distributed import sharding as Sh
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T

    label = "mesh train"
    kb, tok = corpus[0], corpus[2]
    exact_fp32()
    cfg = get_config(LM_TRAIN_ARCH)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    meshes = [make_mesh(s, ("data", "model"), [dev] * (s[0] * s[1]))
              for s in (MESH_TRAIN, MESH_TRAIN_B)]
    shape = ShapeConfig("train", LM_SEQ, LM_BATCH, "train")
    runs = [SP.train_runcfg(LM_TRAIN_ARCH, cfg, shape, m) for m in meshes]
    run = runs[0]
    like = M.init_model(cfg, torch.Generator(), dtype=torch.bfloat16,
                        device="meta")
    shards = [Sh.param_shardings(like, m, cfg) for m in meshes]
    ocfg = O.AdamWCfg()
    data = D.TextFileData([d.text() for d in kb.docs], tok, LM_BATCH, LM_SEQ,
                          seed=args.seed)
    b = {k: torch.from_numpy(v).long().to(dev)
         for k, v in data.batch(LM_TIMED + 3).items()}
    print(f"reduced: phase 16's (data {MESH_TRAIN[0]}, model "
          f"{MESH_TRAIN[1]}) and (data {MESH_TRAIN_B[0]}, model "
          f"{MESH_TRAIN_B[1]}) meshes put all four shards on one card: no "
          "byte crosses cards, every collective is a copy on the card")
    print(f"{label}: {cfg.name} at full width and depth, batch {LM_BATCH} x "
          f"{LM_SEQ} on a {dict(meshes[0].shape)} mesh: heads_sharded "
          f"{run.heads_sharded} ({cfg.n_heads} q and {cfg.n_kv_heads} kv "
          f"heads), repeat_kv {run.repeat_kv}, seq_parallel "
          f"{run.seq_parallel}, remat {run.remat}, {run.attn_impl} "
          f"attention (q_block {run.q_block}, kv_block {run.kv_block})")

    # (a) phase 14's checkpoint onto the mesh against one device's restore
    ck = CK.Checkpointer(TRAIN_CKPT)
    t0 = time.perf_counter()
    one, meta = ck.restore(device=dev)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    one["opt"]["step"] = one["opt"]["step"].cpu()
    t0 = time.perf_counter()
    st, _ = ck.restore(shardings={"params": shards[0],
                                  "opt": O.state_shardings(shards[0])})
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    same_a = _leaves_equal(torch, st, one)
    print(f"{label}: (a) phase 14's checkpoint of step {meta['step']} "
          f"restored onto the mesh in {t_mesh:.2f} s (onto one device "
          f"{t_one:.2f} s): every leaf {'equals' if same_a else 'DIFFERS FROM'}"
          " one device's bit for bit")

    # (b) one step each from that state on the same batch
    def timed_step(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (one["params"], one["opt"], m1), s_one = timed_step(
        lambda: T.make_train_step(cfg, run.replace(mesh=None), ocfg)(
            one["params"], one["opt"], b))
    del one
    release(torch)
    step = T.make_train_step(cfg, run, ocfg)
    p, o = st["params"], st["opt"]
    del st
    (p, o, m), s_first = timed_step(lambda: step(p, o, b))
    d_loss = abs(float(m["loss"]) - float(m1["loss"])) / float(m1["loss"])
    d_norm = abs(float(m["grad_norm"]) - float(m1["grad_norm"])) / \
        float(m1["grad_norm"])
    print(f"{label}: (b) one step from that state, mesh against one device "
          f"(remat on both): loss {float(m['loss']):.6f} vs "
          f"{float(m1['loss']):.6f} ({d_loss:.2e} relative, tol "
          f"{TOL_MESH_TRAIN_LOSS}), grad norm {float(m['grad_norm']):.5f} vs "
          f"{float(m1['grad_norm']):.5f} ({d_norm:.2e}, tol "
          f"{TOL_MESH_TRAIN_NORM}); {s_first:.3f} s vs {s_one:.3f} s (the "
          "first step of each run)")

    # (c) three more mesh steps on that batch, one of them profiled
    peak_ab = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [float(m["loss"])], []
    for _ in range(MESH_TRAIN_STEPS - 1):
        (p, o, m), t = timed_step(lambda: step(p, o, b))
        losses.append(float(m["loss"]))
        times.append(t)
    wall, busy, (p, o, m) = step_profile(torch, lambda: step(p, o, b))
    losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    s_step = float(np.median(times))
    idle = "not measured (the trace held no device activity)" \
        if busy is None else f"{1 - busy / wall:.3f}"
    print(f"{label}: (c) loss over {MESH_TRAIN_STEPS + 1} mesh steps on one "
          "batch: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"{label}: (c) {s_step:.4f} s per step (steps {times}), "
          f"{LM_BATCH * LM_SEQ / s_step:.0f} tokens/s; peak device memory "
          f"{gib(peak):.3f} GiB; one profiled step {wall:.3f} s wall, device "
          f"busy {busy if busy is None else round(busy, 4)} s, idle share "
          f"{idle}; on {card}")

    # (d) saved from the mesh, restored onto (1, 4), stepped there
    work = ROOT / "build" / "chip_smoke" / "mesh_train_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    ck = CK.Checkpointer(work)
    t0 = time.perf_counter()
    ck.save(int(o["step"]), {"params": p, "opt": o}, blocking=True)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, meta = ck.restore(shardings={"params": shards[1],
                                     "opt": O.state_shardings(shards[1])})
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    same_d = _leaves_equal(torch, st, {"params": p, "opt": o})
    del p, o
    release(torch)
    _, _, md = T.make_train_step(cfg, runs[1], ocfg)(st["params"],
                                                     st["opt"], b)
    shutil.rmtree(work, ignore_errors=True)
    counts = ops.launch_counts()
    peak_d = torch.cuda.max_memory_allocated()
    print(f"{label}: (d) saved from the mesh (blocking) in {t_save:.2f} s, "
          f"restored onto {dict(meshes[1].shape)} in {t_b:.2f} s: every "
          f"leaf {'equals' if same_d else 'DIFFERS FROM'} the mesh's bit "
          f"for bit; a step there: loss {float(md['loss']):.6f}")
    print(f"{label}: (e) launches {counts}: decode_attention 0 and "
          "flash_attention 0, as they must be: training decodes nothing and "
          "B4 has no backward, so the mesh runs the blockwise attention of "
          "models/blockwise.py")
    print(f"{label}: readings " + json.dumps({
        "s_per_step": round(s_step, 4),
        "tokens_per_s": round(LM_BATCH * LM_SEQ / s_step, 1),
        "peak_gib": round(gib(peak), 3),
        "idle_share": None if busy is None else round(1 - busy / wall, 3),
        "profiled_wall_s": round(wall, 4)}))
    check(same_a, f"{label}: the mesh's restore differs from one device's")
    check(d_loss <= TOL_MESH_TRAIN_LOSS and d_norm <= TOL_MESH_TRAIN_NORM,
          f"{label}: the mesh step differs from one device's (loss "
          f"{d_loss:.2e}, grad norm {d_norm:.2e})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss on a repeated batch did not fall ({losses})")
    check(same_d, f"{label}: the (1, 4) restore differs from the mesh's "
          "state")
    check(np.isfinite(float(md["loss"])), f"{label}: the (1, 4) step is not "
          "finite")
    check(counts["flash_attention"] == 0 and
          counts["decode_attention"] == 0, f"{label}: an attention kernel "
          f"launched ({counts})")
    del st
    release(torch)
    print(f"{label}: peak device memory with two states on the card: "
          f"{gib(peak_ab):.3f} GiB in (a)-(b), {gib(peak_d):.3f} GiB in "
          "(c)-(d)")
    # phase 17 steps two pods from phase 14's state on this batch
    one_step = {"loss": float(m1["loss"]),
                "grad_norm": float(m1["grad_norm"]), "batch": b,
                "s_step": s_one}
    return {"mesh train": counts}, one_step


# ---------------------------------------------------------------------------
# phase 17: two pods, one process each (distributed/multihost.py)
# ---------------------------------------------------------------------------

POD_COUNT = 2
POD_STEPS = 3                # the compared step, then two more
POD_WAIT_S = 900             # the pod processes' whole run
LAUNCHER_WAIT_S = 300        # (a)'s launcher run, reduced config


def _checksums(torch, tree):
    """``multihost.checksum`` of every tensor of ``tree``, in its order."""
    from repro_torch.distributed import multihost
    from repro_torch.distributed.sharding import parts
    from repro_torch.models.convert import tree_leaves
    return [multihost.checksum(t).tolist() for leaf in tree_leaves(tree)
            for t in parts(leaf)]


def pod_worker(job_path, rank):
    """One pod of phase 17, in a process of its own: joins the ``gloo``
    group, restores phase 14's checkpoint onto its (data 1, model 1) mesh
    of the card (the ranks one after the other, so one 24 GB host copy is
    held at a time), takes its rows ``[rank::2]`` of phase 16's batch and
    runs ``POD_STEPS`` train steps, the last one profiled on rank 0; rank 0
    then saves. Writes ``result{rank}.json`` beside the job."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.index import exact_fp32
    from repro_torch.distributed import multihost
    from repro_torch.distributed import sharding as Sh
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T

    job = json.loads(Path(job_path).read_text())
    out = Path(job["out"])
    exact_fp32()
    multihost.init("gloo", job["init"], rank, POD_COUNT)
    # the launcher's split of the host's cards: both pods on the one card
    devices = multihost.local_devices(job["device"], "gloo")
    dev = devices[0]
    cfg = get_config(LM_TRAIN_ARCH)
    mesh = make_production_mesh(multi_pod=True, devices=devices)
    shape = ShapeConfig("train", LM_SEQ, LM_BATCH // POD_COUNT, "train")
    run = SP.train_runcfg(LM_TRAIN_ARCH, cfg, shape, mesh)
    like = M.init_model(cfg, torch.Generator(), dtype=torch.bfloat16,
                        device="meta")
    shards = Sh.param_shardings(like, mesh, cfg)
    t0 = time.perf_counter()
    for r in range(POD_COUNT):
        if r == rank:
            st, _ = CK.Checkpointer(job["ckpt"]).restore(shardings={
                "params": shards, "opt": O.state_shardings(shards)})
            torch.cuda.synchronize()
        multihost.barrier()
    t_restore = time.perf_counter() - t0
    batch = multihost.pod_rows({k: v.to(dev) for k, v in
                                torch.load(job["batch"]).items()})
    step = T.make_train_step(cfg, run, O.AdamWCfg())
    p, o = st["params"], st["opt"]
    del st
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = {"rank": rank, "mesh": dict(mesh.shape), "restore_s": t_restore,
           "rows": int(batch["tokens"].shape[0]), "steps": []}
    for i in range(POD_STEPS):
        ar0 = multihost.stats["all_reduce_s"]
        profiled = rank == 0 and i == POD_STEPS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            wall, busy, (p, o, m) = step_profile(torch, lambda: step(p, o,
                                                                     batch))
            res["profiled"] = {"wall_s": wall, "busy_s": busy}
        else:
            p, o, m = step(p, o, batch)
            torch.cuda.synchronize()
        res["steps"].append({
            "s": time.perf_counter() - t0, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "all_reduce_s": multihost.stats["all_reduce_s"] - ar0,
            "identical": multihost.replicas_identical({"params": p,
                                                       "opt": o})})
    res.update(counts=ops.launch_counts(),
               peak_gib=gib(torch.cuda.max_memory_allocated()),
               all_reduce_bytes=multihost.stats["all_reduce_bytes"],
               all_reduces=multihost.stats["all_reduces"])
    if rank == 0:
        t0 = time.perf_counter()
        CK.Checkpointer(out / "ck").save(int(o["step"]),
                                         {"params": p, "opt": o},
                                         blocking=True)
        res["save_s"] = time.perf_counter() - t0
        res["checksums"] = _checksums(torch, {"params": p, "opt": o})
    multihost.barrier()
    (out / f"result{rank}.json").write_text(json.dumps(res))
    multihost.shutdown()
    return 0


def _run_pods(job_path, work):
    """Both pod processes of phase 17 (``multihost.spawn``); their logs
    on failure."""
    from repro_torch.distributed import multihost
    try:
        multihost.spawn([sys.executable, str(Path(__file__).resolve()),
                         "--pod-job", str(job_path)], POD_COUNT, POD_WAIT_S,
                        work)
    except RuntimeError as e:
        check(False, f"multihost train: {e}")


def _launcher_pods(torch, work, label, kind):
    """(a): the launcher users call, ``launch/train.py --multipod``, at the
    reduced config on this card. Under NCCL (its default on cuda) two
    pods on one card must refuse to start; over ``gloo`` its two
    processes share the card, train, end identical and checkpoint."""
    from repro_torch.launch import train as L
    from repro_torch.training import checkpoint as CK
    base = ["--arch", LM_TRAIN_ARCH, "--smoke", "--multipod", "--pods",
            str(POD_COUNT), "--device", kind, "--steps", "3"]
    if kind == "cuda" and torch.cuda.device_count() < POD_COUNT:
        try:
            L.main(base)
            refused = "started"
        except ValueError as e:
            refused = str(e)
        print(f"{label}: (a) the launcher with its default backend, nccl, "
              f"{POD_COUNT} pods on {torch.cuda.device_count()} card: "
              f"{refused}")
        check("NCCL refuses" in refused, f"{label}: the launcher did not "
              f"refuse {POD_COUNT} nccl pods on one card ({refused})")
    ck = work / "launcher_ck"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *base,
           "--backend", "gloo", "--ckpt", str(ck)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=LAUNCHER_WAIT_S)[0]
    except subprocess.TimeoutExpired:
        out = f"still running after {LAUNCHER_WAIT_S} s"
    finally:
        if proc.poll() is None:         # the launcher and its pods
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    took = time.perf_counter() - t0
    mesh = f"mesh={{'pod': {POD_COUNT}, 'data': 1, 'model': 1}}"
    step = CK.Checkpointer(ck).latest_step() if ck.exists() else None
    where = "device=cuda:0" if kind == "cuda" else "device=cpu"
    ok = (proc.returncode == 0 and mesh in out and where in out
          and f"pods={POD_COUNT} replicas identical=True" in out
          and out.strip().endswith("done") and step == 3)
    lines = [ln for ln in out.splitlines() if ln.startswith(
        ("train ", "step ", "pods="))]
    print(f"{label}: (a) python -m repro_torch.launch.train "
          f"{' '.join(cmd[3:-2])}: exit "
          f"{proc.returncode} in {took:.1f} s, rank 0 printed: "
          + " | ".join(lines) + f"; checkpoint at step {step}")
    check(ok, f"{label}: (a) the launcher's two gloo pods on the card "
          f"failed:\n{out[-3000:]}")
    shutil.rmtree(ck, ignore_errors=True)


def phase_multihost_train(torch, np, args, card, corpus, dev, one_step):
    """17: (a) the launcher, ``launch/train.py --multipod --pods 2``, at
    the reduced config on the card: refused under its default NCCL (two
    ranks on one card), run over ``gloo`` (two processes, identical state,
    a checkpoint). (b) qwen3-1.7b at full size over two pods, one process
    each on the card (``distributed/multihost.py`` over ``gloo``, started
    by ``multihost.spawn`` as the launcher starts its pods, on the cards
    ``multihost.local_devices`` gives them), each restoring phase 14's
    checkpoint onto its (data 1, model 1) mesh with remat on: one step on
    rows ``[p::2]`` of
    phase 16's batch against phase 16's one-device step on the whole batch
    (loss and grad norm within phase 16's tolerances), both ranks' state
    identical after every step (a per-leaf checksum broadcast from rank
    0), two more steps with a falling loss; s per step, the gradient
    all-reduce's seconds, peak memory per process, the idle share of rank
    0's profiled step, B3 and B4 launches (0). Rank 0's checkpoint,
    restored onto one device, must match its state bit for bit."""
    from repro_torch.training import checkpoint as CK

    label = "multihost train"
    release(torch)
    work = ROOT / "build" / "chip_smoke" / "pods"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.save({k: v.cpu() for k, v in one_step["batch"].items()},
               work / "batch.pt")
    job = work / "job.json"
    job.write_text(json.dumps({
        "ckpt": str(TRAIN_CKPT), "batch": str(work / "batch.pt"),
        "out": str(work), "init": f"file://{work / 'rendezvous'}",
        "device": dev.type}))
    print(f"reduced: phase 17's {POD_COUNT} pods are {POD_COUNT} processes "
          "sharing one card: no byte crosses cards or hosts (the gradient "
          "all-reduce runs over gloo through host memory and loopback)")
    _launcher_pods(torch, work, label, dev.type)
    rows = LM_BATCH // POD_COUNT
    print(f"{label}: (b) {LM_TRAIN_ARCH} at full width and depth, {POD_COUNT} "
          f"pods x a (data 1, model 1) mesh of the card, {rows} of the "
          f"batch's {LM_BATCH} rows x {LM_SEQ} each, remat on, blockwise "
          "attention, gloo")
    t0 = time.perf_counter()
    _run_pods(job, work)
    t_pods = time.perf_counter() - t0
    res = [json.loads((work / f"result{r}.json").read_text())
           for r in range(POD_COUNT)]
    r0 = res[0]
    first = r0["steps"][0]
    d_loss = abs(first["loss"] - one_step["loss"]) / one_step["loss"]
    d_norm = abs(first["grad_norm"] - one_step["grad_norm"]) / \
        one_step["grad_norm"]
    losses = [s["loss"] for s in r0["steps"]]
    same = all(s["identical"] for r in res for s in r["steps"])
    same_loss = all(r["steps"][i]["loss"] == r0["steps"][i]["loss"]
                    for r in res for i in range(POD_STEPS))
    times = [s["s"] for s in r0["steps"]]
    s_step = times[1]
    ar = [round(s["all_reduce_s"], 3) for s in r0["steps"]]
    prof = r0["profiled"]
    busy = prof["busy_s"]
    idle = None if busy is None else 1 - busy / prof["wall_s"]
    counts = {k: sum(r["counts"][k] for r in res) for k in r0["counts"]}
    print(f"{label}: the pods restored phase 14's checkpoint one after the "
          f"other in {r0['restore_s']:.2f} s; {r0['rows']} rows each on "
          f"{r0['mesh']}")
    print(f"{label}: the first step, two pods against phase 16's one device "
          f"on the whole batch: loss {first['loss']:.6f} vs "
          f"{one_step['loss']:.6f} ({d_loss:.2e} relative, tol "
          f"{TOL_MESH_TRAIN_LOSS}), grad norm {first['grad_norm']:.5f} vs "
          f"{one_step['grad_norm']:.5f} ({d_norm:.2e}, tol "
          f"{TOL_MESH_TRAIN_NORM}); the ranks' losses equal: {same_loss}; "
          f"params and AdamW state identical on both ranks after every "
          f"step: {same}")
    print(f"{label}: loss over {POD_STEPS} steps on one batch: "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"{label}: s per step {[round(t, 3) for t in times]} (the last "
          f"profiled on rank 0; phase 16's one-device step "
          f"{one_step['s_step']:.3f} s), {LM_BATCH * LM_SEQ / s_step:.0f} "
          f"tokens/s at step 2; gradient all-reduce per step {ar} s "
          f"({r0['all_reduces']} calls, "
          f"{r0['all_reduce_bytes'] / 1e9:.2f} GB over {POD_STEPS} steps, "
          f"gloo); peak device memory per process "
          f"{[round(r['peak_gib'], 3) for r in res]} GiB; rank 0's profiled "
          f"step {prof['wall_s']:.3f} s wall, device busy "
          f"{busy if busy is None else round(busy, 4)} s, idle share "
          f"{'not measured' if idle is None else round(idle, 3)}; on {card}")
    ck = CK.Checkpointer(work / "ck")
    t0 = time.perf_counter()
    st, meta = ck.restore(device=dev)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    got = _checksums(torch, st)
    del st
    release(torch)
    same_ck = got == r0["checksums"]
    print(f"{label}: rank 0 saved step {meta['step']} in "
          f"{r0['save_s']:.2f} s; restored onto one device in "
          f"{t_restore:.2f} s: every leaf "
          f"{'equals' if same_ck else 'DIFFERS FROM'} rank 0's bit for bit "
          f"({len(got)} leaves)")
    print(f"{label}: launches {counts}: decode_attention 0 and "
          "flash_attention 0, as they must be (training decodes nothing, B4 "
          "has no backward)")
    print(f"{label}: readings " + json.dumps({
        "s_per_step": round(s_step, 4),
        "tokens_per_s": round(LM_BATCH * LM_SEQ / s_step, 1),
        "all_reduce_s": ar, "peak_gib": [round(r["peak_gib"], 3)
                                         for r in res],
        "idle_share": None if idle is None else round(idle, 3),
        "profiled_wall_s": round(prof["wall_s"], 4),
        "pods_s": round(t_pods, 1)}))
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    check(d_loss <= TOL_MESH_TRAIN_LOSS and d_norm <= TOL_MESH_TRAIN_NORM,
          f"{label}: two pods' step differs from one device's (loss "
          f"{d_loss:.2e}, grad norm {d_norm:.2e})")
    check(same and same_loss, f"{label}: the ranks' states differ")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss on a repeated batch did not fall ({losses})")
    check(same_ck, f"{label}: the one-device restore differs from rank 0's "
          "state")
    check(counts["flash_attention"] == 0 and
          counts["decode_attention"] == 0, f"{label}: an attention kernel "
          f"launched ({counts})")
    return {"multihost train": counts}


# ---------------------------------------------------------------------------
# phase 18: the examples' port counterparts
# ---------------------------------------------------------------------------

EX_TRAIN_STEPS, EX_TRAIN_RESUME = 60, 80


def phase_examples(torch, np, args, card, dev):
    """18: ``examples/{quickstart,storinfer_serve,train_small}_torch.py``
    called in process on the card: the quickstart's hit rate equal to the
    same run's on the CPU and B1 launched; the serve example launching B1,
    B3 and B4 and reporting request 1 cancelled; the train example for
    ``EX_TRAIN_STEPS`` steps, then resumed to ``EX_TRAIN_RESUME`` from its
    checkpoint, the loss falling."""
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    import storinfer_serve_torch
    import train_small_torch

    label = "examples"
    release(torch)
    out = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    qs = quickstart_torch.main(["--device", "cuda"])
    t_qs = time.perf_counter() - t0
    out["examples quickstart"] = ops.launch_counts()
    qs_cpu = quickstart_torch.main(["--device", "cpu"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sv = storinfer_serve_torch.main(["--device", "cuda"])
    t_sv = time.perf_counter() - t0
    out["examples serve"] = c_sv = ops.launch_counts()
    work = ROOT / "build" / "chip_smoke" / "train_small"
    shutil.rmtree(work, ignore_errors=True)
    base = ["--device", "cuda", "--ckpt", str(work)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train_small_torch.main(base + ["--steps", str(EX_TRAIN_STEPS)])
    t_tr = time.perf_counter() - t0
    tr2 = train_small_torch.main(base + ["--steps", str(EX_TRAIN_RESUME),
                                         "--resume"])
    out["examples train"] = ops.launch_counts()
    shutil.rmtree(work, ignore_errors=True)
    losses = tr["losses"]
    falls = bool(np.mean(losses[-5:]) < np.mean(losses[:5]))
    print(f"{label}: quickstart_torch on cuda {t_qs:.1f} s: hit rate "
          f"{qs['hit_rate']:.3f} (the same run on the CPU "
          f"{qs_cpu['hit_rate']:.3f}), {qs['index_tier']} index, launches "
          f"{out['examples quickstart']}")
    print(f"{label}: storinfer_serve_torch on cuda {t_sv:.1f} s: query hits "
          f"{sv['query']}, scheduler (cancelled, tokens) {sv['scheduler']}, "
          f"serve (hit, cancelled) {sv['serve']}, launches {c_sv}")
    print(f"{label}: train_small_torch on cuda: {EX_TRAIN_STEPS} steps in "
          f"{t_tr:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; resumed "
          f"at step {tr2['start']} to {EX_TRAIN_RESUME}, loss "
          f"{tr2['losses'][0]:.4f} -> {tr2['losses'][-1]:.4f}; launches "
          f"{out['examples train']} on {card}")
    check(qs["hit_rate"] == qs_cpu["hit_rate"] and qs["generated"] ==
          qs_cpu["generated"], f"{label}: the quickstart on the card "
          f"differs from the CPU ({qs} vs {qs_cpu})")
    check(out["examples quickstart"]["mips_topk"] > 0,
          f"{label}: the quickstart launched no B1")
    check(all(c_sv[k] > 0 for k in ("mips_topk", "decode_attention",
                                    "flash_attention")),
          f"{label}: the serve example skipped a kernel ({c_sv})")
    check(sv["scheduler"][1][0] and not any(
        c for i, (c, _) in enumerate(sv["scheduler"]) if i != 1),
        f"{label}: request 1 was not the one cancelled ({sv['scheduler']})")
    check(falls and all(np.isfinite(losses + tr2["losses"])),
          f"{label}: the train example's loss did not fall ({losses})")
    check(tr2["start"] == EX_TRAIN_STEPS and len(tr2["losses"]) ==
          EX_TRAIN_RESUME - EX_TRAIN_STEPS and
          max(tr2["losses"]) < losses[0],
          f"{label}: the train example did not resume ({tr2})")
    return out


DRY_ARCH = "qwen3-1.7b"
DRY_FIT_GB = 60.0            # 19 (b): the decode batch's memory budget
TOL_PEAK = 0.10              # 19 (b): predicted vs measured peak
MAX_SHARE = 1.05             # 19 (b): bound / measured device time


def _materialize(torch, tree, shardings, dev, g):
    """Meta tensors of a plan's input as seeded tensors on ``dev``: ints
    in [0, 8), floats normal; a leaf with a placement on the (1, 1) mesh
    becomes its one-shard ``Sharded`` (the tensor itself, where
    ``sharding.place`` would copy it)."""
    import numpy as np
    from repro_torch.distributed import sharding as Sh
    if isinstance(tree, dict):
        return {k: _materialize(torch, v, None if shardings is None else
                                shardings[k], dev, g)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_materialize(torch, v, None if shardings is None else
                             shardings[i], dev, g)
                for i, v in enumerate(tree)]
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.dtype.is_floating_point:       # in its dtype: no f32 copy
        t = torch.randn(tree.shape, generator=g, device=dev,
                        dtype=tree.dtype).mul_(0.02)
    else:
        t = torch.randint(0, 8, tree.shape, generator=g, device=dev,
                          dtype=tree.dtype)
    if shardings is None:
        return t
    shards = np.empty((1, 1), dtype=object)
    shards[0, 0] = t
    return Sh.Sharded(shardings.mesh, shards, shardings.spec)


def _card_plan(torch, arch, shape, dev, g):
    """``build_cell``'s plan for ``shape`` on a (data 1, model 1) mesh of
    the card, with seeded inputs in place (AdamW's state made from the
    params by ``optimizer.init``, as the plan's is)."""
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import optimizer as O
    mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
    plan = SP.build_cell(arch, shape, mesh)
    args = [None if plan.kind == "train" and i == 1 else
            _materialize(torch, a, sh, dev, g)
            for i, (a, sh) in enumerate(zip(plan.arg_structs,
                                            plan.in_shardings))]
    if plan.kind == "train":
        args[1] = O.init(args[0])
    return plan, args


def phase_dryrun(torch, np, args, card, dev):
    """19: the dry run's predictions held against the card (see the module
    docstring)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import costs
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_mesh

    label = "dry run"
    out = {}
    cfg = get_config(DRY_ARCH)

    # (a) the production cell, on 256 meta shards of this host
    t0 = time.perf_counter()
    cell = DR.run_cell(DRY_ARCH, "decode_32k", multi_pod=False, probes=True,
                       verbose=False)
    wall = time.perf_counter() - t0
    check(cell["status"] == "ok", f"{label} (a): {cell['status']}")
    r, m = cell["roofline"], cell["memory"]
    print(f"{label} (a): {DRY_ARCH} decode_32k on {cell['mesh']} (256 meta "
          f"shards, {cell['collectives']['method']}): notes "
          f"{cell['notes']}; per device total {m['total_gb']:.3f} GB (args "
          f"{m['args_gb']:.3f}, temp {m['temp_gb']:.3f}), fits 80 GB "
          f"{m['fits_80gb']}; compute {r['compute_s'] * 1e3:.4f} ms, memory "
          f"{r['memory_s'] * 1e3:.4f} ms, collective "
          f"{r['collective_s'] * 1e3:.4f} ms ({r['dominant']}), bound "
          f"{r['bound_step_time_s'] * 1e3:.4f} ms, useful FLOPs "
          f"{r['useful_flops_frac']:.4f}; {wall:.1f} s on the host")
    check(all(np.isfinite([r["compute_s"], r["memory_s"],
                           r["collective_s"]])) and m["total_gb"] > 0,
          f"{label} (a): a term is not finite ({r})")

    # (b) two plans, predicted on meta, then run on the card
    meta = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    train = ShapeConfig(f"train_{LM_BATCH}x{LM_SEQ}", LM_SEQ, LM_BATCH,
                        "train")

    def predict(shape):
        c, secs = DR.count_plan(SP.build_cell(DRY_ARCH, shape, meta))
        t = DR.tally(c, meta)
        return t, DR.roofline(t, cfg, shape, shape.kind), secs

    def decode(b):
        return ShapeConfig(f"decode_32k_b{b}", 32768, b, "decode")

    # the peak grows by a row's cache a row: start from the line through
    # batches 1 and 2, step down until the prediction fits
    p1, p2 = (predict(decode(b))[0]["memory"]["total_gb"] for b in (1, 2))
    B = max(1, min(128, int((DRY_FIT_GB - p1) // (p2 - p1)) + 2))
    while True:
        dec = decode(B)
        pred_dec = predict(dec)
        if pred_dec[0]["memory"]["total_gb"] <= DRY_FIT_GB or B == 1:
            break
        B -= 1
    print(f"reduced: phase 19 (b) {DRY_ARCH} train at {LM_BATCH} x {LM_SEQ} "
          f"tokens (train_4k: 256 x 4096) and decode_32k at batch {B} (of "
          f"128: the largest predicted to fit in {DRY_FIT_GB:.0f} GB), both "
          "on a (data 1, model 1) mesh of the card")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for shape, (t, roof, secs) in ((train, predict(train)), (dec, pred_dec)):
        kind = shape.kind
        release(torch)
        base = torch.cuda.memory_allocated()
        plan, real = _card_plan(torch, DRY_ARCH, shape, dev, g)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        step = lambda: plan.fn(*real)                     # noqa: E731
        ops.reset_launch_counts()
        step()                                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call_ms = time_ms(torch, step, 1, warm=0)
        peak = torch.cuda.max_memory_allocated() - base
        out[f"dry run {kind}"] = ops.launch_counts()
        res = step()
        first = res[0] if kind == "decode" else res[2]["loss"]
        check(bool(torch.isfinite(first.float()).all()),
              f"{label} (b) {kind}: a non-finite result")
        dev_ms = sorted(device_ms(torch, step, 1, warm=0) for _ in range(3))
        pred = t["memory"]["total_gb"] * 1e9
        bound_ms = roof["bound_step_time_s"] * 1e3
        share = bound_ms / dev_ms[1]
        print(f"{label} (b) {kind} {shape.global_batch} x {shape.seq_len} "
              f"(notes {plan.notes}; counted on meta in {secs:.1f} s): "
              f"peak predicted {gib(pred):.3f} GiB (args "
              f"{gib(t['memory']['args_gb'] * 1e9):.3f}), measured "
              f"{gib(peak):.3f} GiB (inputs {gib(held):.3f}), ratio "
              f"{pred / peak:.4f}; step device time {spread(dev_ms)} ms "
              f"(with host gaps {call_ms:.2f} ms), bound {bound_ms:.4f} ms "
              f"({roof['dominant']}: compute {roof['compute_s'] * 1e3:.4f}, "
              f"memory {roof['memory_s'] * 1e3:.4f}), share {share:.4f}; "
              f"products {t['counts']['dot_flops_by_dtype']} on {card}")
        check(abs(pred - peak) <= TOL_PEAK * peak,
              f"{label} (b) {kind}: predicted peak {pred} is not within "
              f"{TOL_PEAK:.0%} of the measured {peak}")
        check(share <= MAX_SHARE,
              f"{label} (b) {kind}: the step took {dev_ms[1]} ms, under its "
              f"bound {bound_ms} ms: the count misses work")
        del plan, real, res, step
    release(torch)

    # (c) the kernels under the counter, on the card and on CPU copies
    from repro_torch.core.store import quantize_rows
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    Q, D, N = 32, 384, N_STORE
    (q8, qs), (x8, xs) = (quantize_rows(rng.standard_normal(
        (n, D), dtype=np.float32)) for n in (Q, N))
    calls = {
        "mips_topk": (lambda q, x: ops.mips_topk(q, x, 1, 512),
                      (unit_rows(torch, g, Q, D, dev),
                       unit_rows(torch, g, N, D, dev).half())),
        "mips_topk_int8": (lambda *a: ops.mips_topk_int8(*a, 1, 512),
                           tuple(torch.from_numpy(a).to(dev)
                                 for a in (q8, qs, x8, xs))),
        "decode_attention": (lambda *a: ops.decode_attention(*a, 8), (
            torch.randn((4, 16, 128), generator=g, device=dev),
            torch.randn((4, 160, 8, 128), generator=g,
                        device=dev).bfloat16(),
            torch.randn((4, 160, 8, 128), generator=g,
                        device=dev).bfloat16(),
            torch.full((4,), 100, dtype=torch.int32, device=dev))),
        "flash_attention": (lambda *a: ops.flash_attention(*a, False), tuple(
            torch.randn(sh, generator=g, device=dev)
            for sh in ((256, 64, 6, 64), (256, 64, 6, 64),
                       (256, 64, 6, 64)))),
    }
    for name, (fn, ins) in calls.items():
        ops.reset_launch_counts()
        on_card = costs.fn_costs(fn, *ins)
        launched = ops.launch_counts()
        on_cpu = costs.fn_costs(fn, *(t.cpu() for t in ins))
        out[f"dry run {name}"] = launched
        keys = ("dot_flops", "bytes_min")
        print(f"{label} (c) {name}: on the card {[on_card[k] for k in keys]}"
              f" (launches {launched[name]}), on the CPU "
              f"{[on_cpu[k] for k in keys]} (dot_flops, bytes_min); credit "
              f"{on_card['kernels'][name]}")
        check(launched[name] == 1 and sum(launched.values()) == 1,
              f"{label} (c) {name}: launches {launched}")
        check(all(on_card[k] == on_cpu[k] for k in keys),
              f"{label} (c) {name}: the card counts {on_card} and the CPU "
              f"{on_cpu}")
    return out


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device).clone()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds every input: store, weights, queries")
    ap.add_argument("--pod-job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.pod_job:             # one of phase 17's pod processes
        return pod_worker(args.pod_job, args.pod_rank)
    t_start = time.perf_counter()

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
    counts, engine, slices = phase_slices(torch, np, args, card, corpus)

    # -- phase 6: the minilm slice (IVF, MiniLM on B4, prefill on B4) ---------
    counts.update(phase_minilm(torch, np, args, card, corpus, engine, dev))

    # -- phase 7: the offline build -------------------------------------------
    counts.update(phase_build(torch, np, args, card, corpus, engine, dev))

    # -- phase 15: the mesh paths on four shards of the card (phase 4's
    #    store and engine) ----------------------------------------------------
    t15 = time.perf_counter()
    counts.update(phase_mesh(torch, np, args, card, corpus, engine, dev,
                             slices))
    print(f"mesh: phase 15 took {time.perf_counter() - t15:.1f} s")
    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)

    # -- phase 8: the paper's 8B model behind the paper store -----------------
    del engine                 # phase 4's qwen3-1.7b, shared by 6 and 7
    release(torch)
    t8 = time.perf_counter()
    counts.update(phase_paper8b(torch, np, args, card, corpus, dev))
    print(f"slice paper8b: phase 8 took {time.perf_counter() - t8:.1f} s")

    # -- phase 9: the rest of the dense family --------------------------------
    t9 = time.perf_counter()
    counts.update(phase_dense_family(torch, np, args, card, corpus, dev))
    print(f"dense family: phase 9 took {time.perf_counter() - t9:.1f} s")

    # -- phase 10: MiniLM contrastive training --------------------------------
    t10 = time.perf_counter()
    counts.update(phase_train(torch, np, args, card, corpus, dev))
    print(f"minilm train: phase 10 took {time.perf_counter() - t10:.1f} s")

    # -- phase 11: the moe family behind the paper store ---------------------
    t11 = time.perf_counter()
    counts.update(phase_moe(torch, np, args, card, corpus, dev))
    print(f"slice moe: phase 11 took {time.perf_counter() - t11:.1f} s")

    # -- phase 12: grok-1, mamba2, zamba2 --------------------------------------
    t12 = time.perf_counter()
    counts.update(phase_families(torch, np, args, card, corpus, dev))
    print(f"families: phase 12 took {time.perf_counter() - t12:.1f} s")

    # -- phase 13: whisper-base and qwen2-vl-72b through the model API -------
    t13 = time.perf_counter()
    counts.update(phase_encdec_vlm(torch, np, args, card, corpus, dev))
    print(f"encdec + vlm: phase 13 took {time.perf_counter() - t13:.1f} s")

    # -- phase 14: training qwen3-1.7b ----------------------------------------
    t14 = time.perf_counter()
    counts.update(phase_train_lm(torch, np, args, card, corpus, dev))
    print(f"train: phase 14 took {time.perf_counter() - t14:.1f} s")

    # -- phase 16: training on a mesh of four shards (phase 14's state) ------
    t16 = time.perf_counter()
    c16, one_step = phase_mesh_train(torch, np, args, card, corpus, dev)
    counts.update(c16)
    print(f"mesh train: phase 16 took {time.perf_counter() - t16:.1f} s")

    # -- phase 17: two pods, one process each, on the card (phase 14's
    #    state, phase 16's one-device step) -----------------------------------
    t17 = time.perf_counter()
    counts.update(phase_multihost_train(torch, np, args, card, corpus, dev,
                                        one_step))
    print(f"multihost train: phase 17 took {time.perf_counter() - t17:.1f} s")

    # -- phase 18: the examples' port counterparts on the card ---------------
    t18 = time.perf_counter()
    counts.update(phase_examples(torch, np, args, card, dev))
    print(f"examples: phase 18 took {time.perf_counter() - t18:.1f} s")

    # -- phase 19: the dry run's predictions against the card ----------------
    t19 = time.perf_counter()
    counts.update(phase_dryrun(torch, np, args, card, dev))
    print(f"dry run: phase 19 took {time.perf_counter() - t19:.1f} s")
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"smoke: the whole run took {time.perf_counter() - t_start:.1f} s")
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
