"""Query embedders for the port.

``HashEmbedder`` — signed n-gram feature hashing (the "hashing trick"),
the same function as the JAX package's ``core/embedder.py:HashEmbedder``:
deterministic, no training, pure numpy, so its output is bitwise equal to
the reference's. It lives in a module of its own because the reference
module imports JAX for its MiniLM encoder, which the port has not taken
over yet (ROADMAP A7).

MIPS on L2-normalized embeddings == cosine similarity (the paper's metric).
"""
from __future__ import annotations

import re
import zlib
from typing import List

import numpy as np

_WORDS = re.compile(r"\w+")


class HashEmbedder:
    def __init__(self, dim: int = 384, ngrams=(1, 2), seed: int = 0):
        self.dim = dim
        self.ngrams = ngrams
        self.seed = seed

    def _features(self, text: str):
        ws = _WORDS.findall(text.lower())
        feats = []
        for n in self.ngrams:
            for i in range(len(ws) - n + 1):
                feats.append(" ".join(ws[i:i + n]))
        return feats

    def encode(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for f in self._features(t):
                h = zlib.crc32((f + f"#{self.seed}").encode())
                idx = h % self.dim
                sign = 1.0 if (h >> 17) & 1 else -1.0
                out[i, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)
