"""StorInfer core, PyTorch port (see the JAX package's ``repro.core``).

  kb         — knowledge bases + user-query distributions (copy)
  tokenizer  — deterministic text tokenizer (copy)
  embedder   — query embedding (hash n-gram features)
  store      — disk-backed precomputed-pair store (copy; same disk format)
  index      — device-resident flat MIPS tier over the store
  runtime    — parallel search + cancellable LLM inference (§3.4, Fig 2)
"""
