"""Data pipeline: deterministic, resumable, shard-aware token batches (a
copy of the JAX package's ``training/data.py``, which is numpy only; the
port keeps its own so it imports nothing of it).

Sources:
  * SyntheticLMData — seeded token stream (throughput/dry-run work)
  * TextFileData    — tokenizes a text corpus (the KB documents double as a
                      tiny pretraining corpus)

Both expose ``batch(step) -> {"tokens", "labels"}`` — a PURE function of
(seed, step), so restart-from-checkpoint replays the exact stream from the
saved cursor with no state files (the cursor IS the step). Multi-host: each
host slices [host_id::n_hosts] of the global batch (here: one host).
"""
from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.V, self.B, self.S = vocab_size, batch, seq_len
        self.seed = seed

    def batch(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(4, self.V, (self.B, self.S + 1), dtype=np.int64)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class TextFileData:
    def __init__(self, texts, tokenizer, batch: int, seq_len: int,
                 seed: int = 0):
        ids = []
        for t in texts:
            ids.extend(tokenizer.encode(t, eos=True))
        self.ids = np.asarray(ids, np.int32)
        self.B, self.S = batch, seq_len
        self.seed = seed
        self.n_windows = max(len(self.ids) - seq_len - 1, 1)

    def batch(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, self.n_windows, self.B)
        toks = np.stack([self.ids[s:s + self.S] for s in starts])
        labs = np.stack([self.ids[s + 1:s + self.S + 1] for s in starts])
        return {"tokens": toks, "labels": labs}
