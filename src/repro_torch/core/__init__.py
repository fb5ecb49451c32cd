"""StorInfer core, PyTorch port (see the JAX package's ``repro.core``).

  kb         — knowledge bases + user-query distributions (copy)
  tokenizer  — deterministic text tokenizer (copy)
  embedder   — query embedding (hash n-gram features; the MiniLM-class
               encoder, with its contrastive training)
  store      — disk-backed precomputed-pair store (copy; same disk format)
  index      — device-resident MIPS tiers over the store (flat, IVF) and
               the offline build's incremental dedup index
  generator  — deduplicated query generation: adaptive query masking +
               adaptive sampling (§3.2; the sequential reference loop; copy)
  precompute — batched, resumable offline build pipeline: wave generation,
               one embed batch + incremental-index dedup per wave,
               checkpointed into the store manifest (§3.2/3.3)
  runtime    — parallel search + cancellable LLM inference (§3.4, Fig 2)
  metrics    — Unigram F1 / ROUGE-L / BERTScore-proxy (§4; copy)
  latency    — the analytic latency model at the paper's H100 point, the
               §4 effective latency and a CUDA-synchronised ``measure``
"""
from __future__ import annotations

import importlib

# exported names -> their module, imported on first use, so importing a
# leaf module (``repro_torch.core.kb``) never pays for torch
_EXPORTS = {
    **dict.fromkeys(("GenCfg", "GenStats", "QueryGenerator", "QueryLM",
                     "SyntheticOracleLM", "chunk_key", "masked_for_chunk"),
                    "generator"),
    "IncrementalIndex": "index",
    **dict.fromkeys(("unigram_f1", "rouge_l_f1", "bert_score_f1",
                     "corpus_mean"), "metrics"),
    **dict.fromkeys(("HwPoint", "H100", "llm_latency", "effective_latency",
                     "measure"), "latency"),
    **dict.fromkeys(("STATE_KEY", "STATE_VERSION", "BuildKilled",
                     "PrecomputeCfg", "PrecomputePipeline",
                     "PrecomputeStats", "chunks_digest"), "precompute"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
