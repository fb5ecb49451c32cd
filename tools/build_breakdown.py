"""Where the time of an offline build goes: the port's launcher's default
build (oracle LM, hash embedder, fp16 store, wave 32, the dedup index on
the card) on one NVIDIA GPU, split into the pipeline's stages.

    python tools/build_breakdown.py [--n-pairs 150000] [--n-docs 500]

Each stage is timed on the host clock around the calls the pipeline makes
(wrappers on the pipeline's components and on the module functions it
calls; the pipeline's code is unchanged). ``max_sim`` reads its result
back, so its time includes the device work it waits for. What the stages
leave of the run's wall time is the wave loop itself (the wave's Gram
check and bookkeeping). One window of ``--window`` waves, from the first
wave past ``--window-at`` rows, runs under ``torch.profiler``: the
device's busy time there and its idle share. The last line is one JSON
object with every number.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILER = "profiler start/stop"


class StageClock:
    """Host seconds and calls per named stage."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def breakdown(n_pairs: int, n_docs: int, device: str, *, seed: int = 0,
              wave: int = 32, flat_max_rows=None, window_at=None,
              window: int = 50, work=None) -> dict:
    """Run the build and return its stage split (host seconds per stage,
    pairs/s below and above the dedup index's IVF boundary, and the
    profiler window's device busy time when ``window_at`` is set)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import SystemCfg, make_pipeline
    from repro_torch.core import precompute as P
    from repro_torch.core.generator import SyntheticOracleLM, chunk_key
    from repro_torch.core.index import FLAT_MAX_ROWS, IncrementalIndex
    from repro_torch.core.kb import build_kb
    from repro_torch.core.store import PrecomputedStore
    from repro_torch.core.tokenizer import Tokenizer

    clock = StageClock()
    flat_max_rows = flat_max_rows or FLAT_MAX_ROWS

    class TimedIndex(IncrementalIndex):
        max_sim = clock.wrap("dedup max_sim", IncrementalIndex.max_sim)
        _append = clock.wrap("dedup append", IncrementalIndex._append)
        _refit = clock.wrap("dedup refit", IncrementalIndex._refit)

    kb = build_kb("squad", seed=seed, n_docs=n_docs)
    cfg = SystemCfg(device=device, precompute=P.PrecomputeCfg(
        wave=wave, flat_max_rows=flat_max_rows))
    pipe = make_pipeline(cfg, SyntheticOracleLM(kb),
                         Tokenizer.from_texts([d.text() for d in kb.docs]))
    chunks = [chunk_key(d.doc_id, d.text()) for d in kb.docs]
    lm = pipe.lm
    lm.generate_query = clock.wrap("generate (oracle LM)", lm.generate_query)
    lm.answer = clock.wrap("answer (oracle LM)", lm.answer)
    pipe.embedder.encode = clock.wrap("encode (hash)", pipe.embedder.encode)
    pipe._checkpoint = clock.wrap("checkpoint flush", pipe._checkpoint)
    saved = {k: getattr(P, k) for k in ("masked_for_chunk",
                                        "roundtrip_dtype",
                                        "IncrementalIndex")}
    P.masked_for_chunk = clock.wrap("query masking", P.masked_for_chunk)
    P.roundtrip_dtype = clock.wrap("fp16 round trip", P.roundtrip_dtype)
    P.IncrementalIndex = TimedIndex

    work = Path(work or ROOT / "build" / "build_breakdown")
    shutil.rmtree(work, ignore_errors=True)
    store = PrecomputedStore(work, dim=pipe.embedder.dim,
                             emb_dtype=cfg.emb_dtype,
                             shard_rows=cfg.shard_rows)
    store.add_batch = clock.wrap("store add_batch", store.add_batch)
    on_cuda = device.startswith("cuda")
    marks, win = {}, {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])

    def start_window(waves, generated, mode):
        win.update(prof=profile(activities=acts), waves=waves,
                   rows=generated, mode=mode)
        if on_cuda:
            torch.cuda.synchronize()
        win["prof"].start()
        win["start"] = time.perf_counter()

    def stop_window():
        if on_cuda:
            torch.cuda.synchronize()
        win["wall"] = time.perf_counter() - win["start"]
        win["prof"].stop()

    # the profiler's own start and stop are a stage of their own, so the
    # other stages and the rest of the loop keep their meaning
    start_window = clock.wrap(PROFILER, start_window)
    stop_window = clock.wrap(PROFILER, stop_window)

    def on_wave(waves, generated, discarded, mode):
        if mode == "ivf" and "ivf" not in marks:
            marks["ivf"] = (time.perf_counter(), generated)
        if window_at is not None and "start" not in win \
                and generated >= window_at:
            start_window(waves, generated, mode)
        elif "start" in win and "wall" not in win \
                and waves - win["waves"] >= window:
            stop_window()

    t0 = time.perf_counter()
    try:
        _, _, _, st = pipe.run(chunks, n_pairs, store=store, seed=seed,
                               on_wave=on_wave)
    finally:
        for k, v in saved.items():
            setattr(P, k, v)
        store.close()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    unprofiled = st.run_seconds - clock.seconds.get(PROFILER, 0.0)
    out = {
        "device": device, "n_pairs": n_pairs, "n_docs": n_docs,
        "wave": wave, "flat_max_rows": flat_max_rows,
        "generated": st.generated, "discarded": st.discarded,
        "waves": st.waves, "run_seconds": st.run_seconds, "wall": wall,
        "pairs_per_sec": st.pairs_per_sec,
        "pairs_per_sec_without_profiler": st.generated / unprofiled,
        "index_mode": st.index_mode,
        "refits": st.refits, "refit_seconds": st.refit_seconds,
        "stages": {k: {"seconds": v, "calls": clock.calls[k]}
                   for k, v in sorted(clock.seconds.items(),
                                      key=lambda kv: -kv[1])},
    }
    out["stages"]["rest of the wave loop"] = {
        "seconds": st.run_seconds - sum(clock.seconds.values()),
        "calls": st.waves}
    if "ivf" in marks:
        # rates on each side of the dedup index's IVF boundary; the
        # profiler window opens past it, so its cost leaves the ivf side
        t_ivf, rows = marks["ivf"]
        out["flat_pairs_per_sec"] = rows / (t_ivf - t0)
        out["ivf_pairs_per_sec"] = (st.generated - rows) / (
            t0 + st.run_seconds - t_ivf - clock.seconds.get(PROFILER, 0.0))
    if "wall" in win:
        out["window"] = _window(win, on_cuda)
    return out


def _window(win, on_cuda) -> dict:
    ev = win["prof"].key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in ev if dev_us(e) > 0
                      and e.self_cpu_time_total == 0),
                     key=lambda e: -dev_us(e))
    busy = sum(dev_us(e) for e in kernels) / 1e6
    return {"waves": win["waves"], "rows": win["rows"], "mode": win["mode"],
            "wall": win["wall"], "device_busy": busy if on_cuda else None,
            "device_idle_share": 1 - busy / win["wall"] if on_cuda else None,
            "top_device": [(e.key[:60], dev_us(e) / 1e3, e.count)
                           for e in kernels[:6]],
            "launches": sum(e.count for e in ev
                            if e.key.startswith("cudaLaunchKernel"))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-pairs", type=int, default=150_000)
    ap.add_argument("--n-docs", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-at", type=int, default=100_000,
                    help="rows after which the profiler window opens")
    ap.add_argument("--window", type=int, default=50,
                    help="waves in the profiler window")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("build_breakdown.py runs only on a GPU", file=sys.stderr)
        return 2
    out = breakdown(args.n_pairs, args.n_docs, "cuda", seed=args.seed,
                    window_at=args.window_at, window=args.window)
    out["card"] = torch.cuda.get_device_name(0)
    print(f"build of {out['generated']} pairs ({out['discarded']} "
          f"discarded) in {out['run_seconds']:.2f} s, "
          f"{out['pairs_per_sec']:.1f} pairs/s "
          f"({out['pairs_per_sec_without_profiler']:.1f} without the "
          f"profiler's start and stop); flat mode "
          f"{out.get('flat_pairs_per_sec', float('nan')):.1f} pairs/s, ivf "
          f"{out.get('ivf_pairs_per_sec', float('nan')):.1f} pairs/s on "
          f"{out['card']}")
    for name, s in out["stages"].items():
        print(f"  {name:24s} {s['seconds']:9.3f} s "
              f"({s['seconds'] / out['run_seconds']:.3f} of the run) "
              f"x{s['calls']}")
    w = out.get("window")
    if w:
        print(f"profiler window: {args.window} waves from {w['rows']} rows "
              f"({w['mode']}): wall {w['wall'] * 1e3:.1f} ms, device busy "
              f"{w['device_busy'] * 1e3:.2f} ms, idle share "
              f"{w['device_idle_share']:.3f}, {w['launches']} launches")
        for name, ms, n in w["top_device"]:
            print(f"  device {ms:9.3f} ms x{n:<5d} {name}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
