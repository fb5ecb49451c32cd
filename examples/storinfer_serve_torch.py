"""End-to-end StorInfer serving on the PyTorch port (the counterpart of
``examples/storinfer_serve.py``; CUDA unless ``--device cpu``): a torch LM
behind the runtime, with parallel vector search and chunked-decode
hit-cancellation (Fig 2), the continuous-batching scheduler path, and the
batched serving runtime (microbatched admission -> one embed + one MIPS
search + one batched decode, hit slots cancelled mid-flight). The whole
system is assembled declaratively through the ``StorInfer`` facade — one
``SystemCfg`` names the embedder, the index tier, the runtime thresholds,
and the engine arch. On a card the search runs the ``mips_topk`` kernel,
prefill ``flash_attention`` and decode ``decode_attention``.

  PYTHONPATH=src python examples/storinfer_serve_torch.py [--device cpu]

``--n-pairs`` sizes the store (the reference script's 600 by default).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import EngineCfg, StorInfer, SystemCfg  # noqa: E402
from repro_torch.core.kb import build_kb, sample_user_queries  # noqa: E402
from repro_torch.core.runtime import BatchedRuntimeCfg  # noqa: E402
from repro_torch.core.tokenizer import Tokenizer  # noqa: E402
from repro_torch.serving.engine import BatchScheduler, Request  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-pairs", type=int, default=600)
    args = ap.parse_args(argv)

    kb = build_kb("squad", n_docs=10)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=1024)

    # one declarative config: tiny fallback LM (random weights at full
    # width via smoke=False), batched admission window, runtime threshold
    cfg = SystemCfg(
        s_th_run=0.9,
        batched=BatchedRuntimeCfg(max_batch=8, max_wait_s=0.02),
        engine=EngineCfg(arch="llama3.2-3b", smoke=True, max_len=128,
                         chunk=4),
        device=args.device)
    out = {"query": [], "scheduler": [], "serve": []}

    with tempfile.TemporaryDirectory() as td, \
            StorInfer.build(kb, cfg, td, n_pairs=args.n_pairs,
                            tokenizer=tok) as si:
        user = sample_user_queries(kb, 6, seed=3)

        print("=== parallel search + cancellable decode (Fig 2) ===")
        for q, _ in user:
            r = si.query(q, max_new=16)
            out["query"].append(r.hit)
            print(f"[{r.source:5s} hit={r.hit} chunks={r.chunks_run} "
                  f"lat={r.latency_s:.3f}s] {q!r}")

        print("=== continuous batching with per-slot cancellation ===")
        sched = BatchScheduler(si.engine, batch_size=2)
        for i, (q, _) in enumerate(user[:4]):
            sched.submit(Request(rid=i, prompt=q, max_new=8))
        # a StorInfer hit arrives for request 1 -> cancel mid-flight
        sched.cancel(1)
        done = sched.run_to_completion()
        for r in sorted(done, key=lambda r: r.rid):
            out["scheduler"].append((r.cancelled, len(r.out_ids)))
            print(f"req {r.rid}: cancelled={r.cancelled} "
                  f"tokens={len(r.out_ids)}")

        print("=== batched StorInfer serving (auto-tiered index) ===")
        with si.serve():
            futs = [si.submit(q, max_new=8) for q, _ in user]
            for (q, _), f in zip(user, futs):
                r = f.result(timeout=120)
                out["serve"].append((r.hit, r.cancelled))
                print(f"[{r.source:5s} hit={r.hit} "
                      f"cancelled={r.cancelled}] {q!r}")
        s = si.stats().runtime
        print(f"stats: {s.queries} queries, {s.hits} hits "
              f"({s.hit_rate:.0%}), {s.llm_cancelled} decodes "
              f"hit-cancelled, {s.batches} microbatches")
    return out


if __name__ == "__main__":
    main()
