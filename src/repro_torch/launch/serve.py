"""Serving launcher: the port's StorInfer facade in front of the fallback
LM, on one CUDA device unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
      --index flat --store runs/store

Opens the precomputed store at ``--store``; when there is none it writes
one first (``write_kb_store``: the KB's question pairs, then seeded filler
pairs up to ``--n-pairs`` rows, which sizes a store in seconds; the
offline generator is ``launch/precompute.py``). It then serves a user-query stream two ways: the paper's
sequential race, and the staged serving pipeline (``serve()`` /
``submit()``), reporting hit rate and hit/miss latency. ``--arch`` picks
the fallback LM (``deepseek-v2-lite-16b``, ``mamba2-130m``, ... any
registered config the engine serves: not the encdec or vlm families,
which need frames or M-RoPE positions); ``--no-smoke`` serves its full
config instead of the reduced smoke one.
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.api import EngineCfg, StorInfer, SystemCfg
from repro_torch.configs import get_config, list_configs
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.kb import (TEMPLATES, build_kb, render_query,
                                 sample_user_queries)
from repro_torch.core.store import PrecomputedStore
from repro_torch.core.tokenizer import Tokenizer


def kb_pairs(kb):
    """The KB's (query, answer) pairs: every fact under every anticipated
    paraphrase template, first occurrence of each query text kept."""
    seen, pairs = set(), []
    for f in kb.facts:
        for t in range(len(TEMPLATES)):
            q = render_query(f, t)
            if q not in seen:
                seen.add(q)
                pairs.append((q, f.answer()))
    return pairs


def write_kb_store(path, kb, embedder, n_rows: int, *, seed: int = 0,
                   emb_dtype: str = "float16",
                   chunk: int = 32768) -> PrecomputedStore:
    """A store of ``n_rows`` pairs: the KB pairs (embedded with
    ``embedder``), then filler pairs whose embeddings are seeded random
    unit vectors (they never clear a serving threshold against real
    queries, but they give the scan its full size)."""
    pairs = kb_pairs(kb)[:n_rows]
    store = PrecomputedStore(path, dim=embedder.dim, emb_dtype=emb_dtype)
    qs = [q for q, _ in pairs]
    store.add_batch(embedder.encode(qs), qs, [r for _, r in pairs])
    rng = np.random.default_rng(seed)
    for lo in range(len(pairs), n_rows, chunk):
        n = min(chunk, n_rows - lo)
        e = rng.standard_normal((n, embedder.dim), dtype=np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        store.add_batch(e, [f"filler query {lo + i}" for i in range(n)],
                        [f"filler response {lo + i}" for i in range(n)])
    store.flush()
    return store


def servable():
    """The registered archs the serving engine takes."""
    return [a for a in list_configs()
            if get_config(a).family not in ("encdec", "vlm")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=servable(),
                    help="the fallback LM: any registered arch of the "
                         "dense, moe, ssm and hybrid families (the engine "
                         "prefills tokens only, so not encdec or vlm)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced arch config (--no-smoke loads the full "
                         "one)")
    ap.add_argument("--dataset", default="squad")
    ap.add_argument("--n-pairs", type=int, default=800,
                    help="rows of the store written when --store has none")
    ap.add_argument("--n-queries", type=int, default=40)
    ap.add_argument("--s-th-run", type=float, default=0.9)
    ap.add_argument("--index", choices=("auto", "flat", "ivf"),
                    default="auto",
                    help="auto picks the tier from store size")
    ap.add_argument("--store", default=None,
                    help="store dir (default: temp, written anew)")
    ap.add_argument("--decode-slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    kb = build_kb(args.dataset, n_docs=20)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=2048)
    cfg = SystemCfg(index=args.index, s_th_run=args.s_th_run,
                    decode_slots=args.decode_slots, device=args.device,
                    engine=EngineCfg(arch=args.arch, smoke=args.smoke,
                                     max_len=160, chunk=8))

    store_dir = Path(args.store or tempfile.mkdtemp(prefix="storinfer_"))
    if not (store_dir / "manifest.json").exists():
        write_kb_store(store_dir, kb, HashEmbedder(), args.n_pairs).close()
        print(f"wrote store: {store_dir}")
    with StorInfer.open(store_dir, cfg, tokenizer=tok) as si:
        print(f"loaded store: {si.store.count} pairs on {args.device}")
        user = sample_user_queries(kb, args.n_queries, seed=9)
        hits, lat = 0, []
        for q, _ in user:
            r = si.query(q, max_new=16)
            hits += r.hit
            lat.append(r.latency_s)
        print(f"sequential race: hit_rate={hits / len(user):.3f} "
              f"mean_latency={np.mean(lat):.3f}s p50={np.median(lat):.3f}s")

        with si.serve():
            futs = [si.submit(q, max_new=16) for q, _ in user]
            results = [f.result(timeout=600) for f in futs]
        hit_lat = [r.latency_s for r in results if r.hit]
        miss_lat = [r.latency_s for r in results if not r.hit]
        parts = []
        if hit_lat:
            parts.append(f"hit_p50={np.median(hit_lat) * 1e3:.1f}ms")
        if miss_lat:
            parts.append(f"miss_p50={np.median(miss_lat) * 1e3:.1f}ms")
        print(f"staged pipeline: {' '.join(parts) or 'no queries'}")
        snap = si.stats().pipeline
        if snap:
            depth = {k: v["items"] for k, v in snap["stages"].items()}
            print(f"  stage items: {depth}  "
                  f"search_batches={snap['search_batches']}")


if __name__ == "__main__":
    main()
