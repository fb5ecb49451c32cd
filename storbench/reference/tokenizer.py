"""Deterministic word-piece-lite tokenizer: the benchmark's own copy of the
port's ``core/tokenizer.py``, with which the reference tokenises the
prompts again instead of taking the program's ids.

Whitespace/punctuation word split with a frequency-built vocab and a
byte-fallback for OOV — enough to (a) count token budgets for adaptive query
masking exactly, (b) drive the LMs end-to-end (ids -> text -> ids).
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Iterable, List

_SPLIT = re.compile(r"\w+|[^\w\s]")

PAD, BOS, EOS, UNK = 0, 1, 2, 3
N_SPECIAL = 4
N_BYTES = 256  # byte fallback ids live at [N_SPECIAL, N_SPECIAL + 256)


class Tokenizer:
    def __init__(self, vocab: List[str]):
        self.words = list(vocab)
        self.word_to_id = {w: N_SPECIAL + N_BYTES + i
                           for i, w in enumerate(self.words)}
        self.vocab_size = N_SPECIAL + N_BYTES + len(self.words)
        # count() memoization: adaptive query masking re-budgets the same
        # chunk texts and recent queries on every candidate — tokenizing
        # them each time was >60% of offline generation wall-clock
        self._count_cache: dict = {}

    @classmethod
    def from_texts(cls, texts: Iterable[str], max_vocab: int = 8192):
        counts = Counter()
        for t in texts:
            counts.update(w.lower() for w in _SPLIT.findall(t))
        vocab = [w for w, _ in counts.most_common(max_vocab)]
        return cls(vocab)

    def encode(self, text: str, *, bos: bool = False, eos: bool = False):
        ids = [BOS] if bos else []
        for w in _SPLIT.findall(text.lower()):
            wid = self.word_to_id.get(w)
            if wid is not None:
                ids.append(wid)
            else:
                ids.extend(N_SPECIAL + b for b in w.encode("utf-8"))
        if eos:
            ids.append(EOS)
        return ids

    def decode(self, ids) -> str:
        out, byte_buf = [], []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i < N_SPECIAL:
                continue
            if i < N_SPECIAL + N_BYTES:
                byte_buf.append(i - N_SPECIAL)
            else:
                flush()
                w = i - N_SPECIAL - N_BYTES
                if w < len(self.words):
                    out.append(self.words[w])
        flush()
        return " ".join(out)

    def count(self, text: str) -> int:
        n = self._count_cache.get(text)
        if n is None:
            if len(self._count_cache) >= 65536:   # bound the memo
                self._count_cache.clear()
            n = self._count_cache[text] = len(self.encode(text))
        return n
