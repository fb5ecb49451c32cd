"""StorInfer core, PyTorch port (see the JAX package's ``repro.core``).

  kb         — knowledge bases + user-query distributions (copy)
  tokenizer  — deterministic text tokenizer (copy)
  embedder   — query embedding (hash n-gram features)
  store      — disk-backed precomputed-pair store (copy; same disk format)
  index      — device-resident MIPS tiers over the store (flat, IVF) and
               the offline build's incremental dedup index
  generator  — deduplicated query generation: adaptive query masking +
               adaptive sampling (§3.2; the sequential reference loop; copy)
  precompute — batched, resumable offline build pipeline: wave generation,
               one embed batch + incremental-index dedup per wave,
               checkpointed into the store manifest (§3.2/3.3)
  runtime    — parallel search + cancellable LLM inference (§3.4, Fig 2)
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
