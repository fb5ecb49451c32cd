"""Offline precompute launcher of the PyTorch port: paper-scale store
builds (§3.2/§3.3), the dedup index (and a MiniLM embedder) on one CUDA
device unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.precompute \
      --dataset squad --n-pairs 150000 --wave 32 --store runs/squad150k

Builds (or resumes — the default when the store directory already holds a
checkpointed build) a deduplicated precomputed-query store via
``StorInfer.build`` (the batched ``PrecomputePipeline`` underneath), then
fits and persists the serving index into the store root so
``StorInfer.open`` / ``BatchedRuntime.from_store(..., cache_dir="store")``
reopen it without re-running k-means. Kill it any time: rerunning the same
command continues from the last checkpoint and produces a store
byte-identical to an uninterrupted run.
"""
import argparse
import json
import time
from pathlib import Path

from repro_torch.api import StorInfer, SystemCfg, tier_of
from repro_torch.core.kb import build_kb
from repro_torch.core.precompute import STATE_KEY, PrecomputeCfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="squad",
                    choices=("squad", "narrativeqa", "triviaqa"))
    ap.add_argument("--n-docs", type=int, default=None,
                    help="KB size (default: dataset profile)")
    ap.add_argument("--n-pairs", type=int, default=150_000,
                    help="target deduplicated pairs (paper: 150K)")
    ap.add_argument("--wave", type=int, default=32,
                    help="candidates per batched step")
    ap.add_argument("--store", required=True, help="store directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    help="waves between resume checkpoints")
    # audited for the serve.py store_true/default=True trap: these three
    # default to False, so plain store_true keeps both states reachable
    ap.add_argument("--background-recluster", action="store_true",
                    help="refit the dedup IVF in a thread (faster, gives "
                         "up kill/resume determinism)")
    ap.add_argument("--embedder", choices=("hash", "minilm"),
                    default="hash")
    ap.add_argument("--emb-dtype",
                    choices=("float16", "float32", "int8"),
                    default="float16",
                    help="store embedding dtype; int8 writes symmetric "
                         "per-row quantized shards + f32 scales (~26%% of "
                         "fp32 bytes) served by the device-resident int8 "
                         "MIPS path")
    ap.add_argument("--fresh", action="store_true",
                    help="refuse to resume; store dir must be empty")
    ap.add_argument("--no-index", action="store_true",
                    help="skip fitting + persisting the serving index")
    ap.add_argument("--device", default="cuda",
                    help="where the dedup index, a MiniLM embedder and the "
                         "serving index run")
    args = ap.parse_args(argv)

    kb = build_kb(args.dataset, seed=args.seed, n_docs=args.n_docs)
    cfg = SystemCfg(
        embedder=args.embedder,
        index="none" if args.no_index else "auto",
        emb_dtype=args.emb_dtype, device=args.device,
        precompute=PrecomputeCfg(
            wave=args.wave, checkpoint_every=args.checkpoint_every,
            background_recluster=args.background_recluster))

    manifest = Path(args.store) / "manifest.json"
    if manifest.exists():
        man = json.loads(manifest.read_text())
        done = man.get("extra", {}).get(STATE_KEY, {}).get("generated", "?")
        print(f"resuming store {args.store}: {man.get('count', '?')} rows "
              f"(checkpoint says {done})")
    else:
        print(f"fresh store {args.store}")

    t0 = time.perf_counter()
    last = [t0]

    def on_wave(waves, generated, discarded, mode):
        if time.perf_counter() - last[0] >= 5.0:
            last[0] = time.perf_counter()
            rate = generated / (time.perf_counter() - t0 + 1e-9)
            print(f"  wave {waves}: {generated}/{args.n_pairs} pairs "
                  f"({discarded} discarded, dedup={mode}, "
                  f"{rate:.0f} pairs/s this run)")

    si = StorInfer.build(kb, cfg, args.store, n_pairs=args.n_pairs,
                         seed=args.seed, resume=not args.fresh,
                         on_wave=on_wave)
    with si:
        stats = si.build_stats
        print(f"build wall time {time.perf_counter() - t0:.1f}s (serving "
              f"index included), {stats.waves} waves, slowest "
              f"{stats.max_wave_seconds:.3f}s")
        sb = si.store.storage_bytes()
        print(f"build done: {si.store.count} rows "
              f"({stats.generated} this run, {stats.discarded} discarded, "
              f"{stats.pairs_per_sec:.0f} pairs/s, "
              f"dedup index ended {stats.index_mode}, {stats.refits} "
              f"refits in {sum(stats.refit_seconds):.2f}s); "
              f"store {sb['total_bytes'] / 1e6:.1f} MB "
              f"({sb['index_bytes'] / 1e6:.1f} embeddings + "
              f"{sb['metadata_bytes'] / 1e6:.1f} metadata)")

        if si.index is not None:
            tier = tier_of(si.index)
            how = "loaded" if getattr(si.index, "loaded_from", None) \
                else "built"
            dt = si.index_seconds
            print(f"serving index: {tier} {how} in {dt:.1f}s "
                  f"(cache: {si.store.root}/index_ivf.npz)"
                  if tier == "ivf" else
                  f"serving index: {tier} ({dt:.1f}s; nothing to cache "
                  "below the IVF boundary)")


if __name__ == "__main__":
    main()
