"""Quickstart on the PyTorch port: the whole StorInfer system through its
one front door — build a precomputed-query store from a knowledge base,
then serve queries against it (the counterpart of
``examples/quickstart.py``; CUDA unless ``--device cpu``):

    kb = build_kb("squad", n_docs=25)
    with StorInfer.build(kb, SystemCfg(), path, n_pairs=1500) as si:
        result = si.query("what is the height of aurora bridge?")

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--n-docs``, ``--n-pairs`` and ``--queries`` size the run (the
defaults are the reference script's).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import StorInfer, SystemCfg  # noqa: E402
from repro_torch.core.kb import build_kb, sample_user_queries  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-docs", type=int, default=25)
    ap.add_argument("--n-pairs", type=int, default=1500)
    ap.add_argument("--queries", type=int, default=400)
    args = ap.parse_args(argv)

    # a knowledge base (stands in for the paper's SQuAD documents)
    kb = build_kb("squad", n_docs=args.n_docs)

    with tempfile.TemporaryDirectory() as td:
        # OFFLINE: batched deduplicated query generation into the store
        # (checkpointed — rerunning after a kill resumes from the manifest)
        with StorInfer.build(kb, SystemCfg(device=args.device), td,
                             n_pairs=args.n_pairs) as si:
            st = si.build_stats
            store_bytes = si.store.storage_bytes()["total_bytes"]
            print(f"generated {st.generated} pairs in {st.waves} waves "
                  f"({st.discarded} near-duplicates discarded, "
                  f"{st.seconds:.1f}s, {st.pairs_per_sec:.0f} pairs/s); "
                  f"store = {store_bytes / 1e6:.2f} MB")

            # ONLINE: queries hit the store or fall through
            user = sample_user_queries(kb, args.queries, seed=5)
            hits = sum(si.query(q).hit for q, _ in user)
            print(f"hit rate @0.9 over {len(user)} user queries: "
                  f"{hits / len(user):.3f}")
            r = si.query(user[0][0])
            print(f"example: {user[0][0]!r}\n  -> [{r.source}] "
                  f"{r.response!r} (search {r.search_s * 1e3:.2f} ms)")
            s = si.stats()
            print(f"system: {s.store_rows} rows behind a {s.index_tier} "
                  f"index, {s.runtime.queries} queries served")
            return {"generated": st.generated, "store_bytes": store_bytes,
                    "hit_rate": hits / len(user), "example": r.response,
                    "source": r.source, "index_tier": s.index_tier}


if __name__ == "__main__":
    main()
