"""Disk-backed precomputed query-response store (§3.3).

The code is a copy of the JAX package's ``core/store.py``: the on-disk
format is shared, so one store serves both packages.

Layout on disk (root/): see docs/ARCHITECTURE.md for the full format table.
  manifest.json          — dim, dtype, count, shard list, shard_rows,
                           text_bytes (crash-recovery watermark), extra
                           (e.g. the precompute pipeline's ``gen_state``
                           resume checkpoint)
  emb_XXXX.npy           — embedding shards, (rows, dim) float16 memmap
                           (or int8 when ``emb_dtype="int8"``)
  emb_XXXX_scale.npy     — int8 stores only: the shard's per-row f32
                           dequant scales (rows,)
  text.jsonl             — one {"q": query, "r": response} per row
  offsets.npy            — byte offset of each row in text.jsonl
  index_ivf.npz          — optional persisted IVF index (auto_index cache)

Quantized stores (``emb_dtype="int8"``): rows are quantized symmetrically
per row — ``values = rint(row / scale)`` with ``scale = max|row| / 127`` —
as they are ingested, so a shard on disk is int8 values plus an f32 scale
per row (~26% of the fp32 bytes, ~51% of fp16; the paper's 830 MB edge
budget shrinks accordingly). Per-row quantization makes shard layout a
pure function of the row sequence (merging a partial tail shard is a
plain concatenation, no re-quantization), which is what keeps killed +
resumed builds byte-identical. ``embeddings()`` returns a
``QuantizedShardedEmbeddings`` view that dequantizes on access and
exposes the raw int8 parts for device upload (the int8 serving path in
core/index.py / kernels/mips_topk_int8.py). Old fp32/fp16 manifests are
untouched by any of this and load exactly as before.

Embeddings are the "index tier" (paper: 810 MB DiskANN index for 150K),
responses the "metadata tier" (paper: 20 MB); ``storage_bytes()`` reports
the same split for Fig 4 / §4. Appends flush shard-at-a-time; ``open_``
memory-maps the shards so a store larger than RAM still serves (the
storage-as-memory-tier premise of the paper, adapted: host RAM/NVMe is the
backing tier, device HBM the scan tier).

Crash safety: ``flush()`` writes offsets.npy and manifest.json atomically
(tmp + rename) and records the committed text.jsonl byte length; ``open_``
truncates any trailing bytes a killed writer appended past the last flush,
so a resumed build continues from exactly the committed prefix.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

SHARD_ROWS = 32768


# ---------------------------------------------------------------------------
# Symmetric per-row int8 quantization (the ``emb_dtype="int8"`` store format
# and the query-side quantization of the int8 serving path)
# ---------------------------------------------------------------------------


def quantize_rows(embs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) float -> (int8 values (n, d), f32 scales (n,)).

    Symmetric per-row: ``scale = max|row| / 127``, ``values =
    rint(row / scale)`` (zero rows get scale 1 so dequant stays exact).
    Quantizing an already-round-tripped row reproduces it bit-for-bit —
    the max element maps back to exactly ±127 — which is what lets shard
    merges and resumed builds stay byte-identical without ever keeping
    the original f32 around."""
    embs = np.asarray(embs, np.float32)
    amax = np.abs(embs).max(axis=1) if embs.shape[0] else \
        np.zeros((0,), np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    vals = np.clip(np.rint(embs / scale[:, None]), -127, 127)
    return vals.astype(np.int8), scale


def dequantize_rows(vals: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of ``quantize_rows``: int8 (n, d) + f32 (n,) -> f32 (n, d)."""
    return np.asarray(vals, np.float32) * \
        np.asarray(scale, np.float32)[:, None]


def roundtrip_dtype(embs: np.ndarray, dtype) -> np.ndarray:
    """f32 embeddings as they will read back from a store of ``dtype`` —
    the dedup pipeline scores on this so an in-run index and one rebuilt
    from disk see bit-identical similarities (core/precompute.py)."""
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        return dequantize_rows(*quantize_rows(embs))
    if dtype == np.float32:
        return np.asarray(embs, np.float32)
    return np.asarray(embs).astype(dtype).astype(np.float32)


class ShardedEmbeddings:
    """Lazy row-concatenated view over embedding shards.

    ``embeddings(mmap=True)`` used to ``np.concatenate`` every shard into
    RAM — defeating the memmap for exactly the multi-shard stores that need
    it. This view keeps the shards as-is (memmaps for flushed shards, small
    ndarrays for pending rows) and quacks enough like an (N, D) array for
    the index builders: ``shape``/``dtype``/``len``, row indexing/slicing,
    ``take`` (row gather that touches only the requested rows per shard),
    and ``np.asarray`` for callers that explicitly want a materialized copy.
    Index builds iterate ``iter_shards()`` so peak host memory is one shard,
    not the store.
    """

    def __init__(self, parts: List[np.ndarray], dim: int, dtype):
        self.parts = parts
        self.shape = (int(sum(p.shape[0] for p in parts)), dim)
        self.dtype = np.dtype(dtype)
        self.ndim = 2

    def __len__(self) -> int:
        return self.shape[0]

    def iter_shards(self) -> Iterator[np.ndarray]:
        yield from self.parts

    def __array__(self, dtype=None, copy=None):
        if not self.parts:
            return np.zeros(self.shape, dtype or self.dtype)
        out = np.concatenate([np.asarray(p) for p in self.parts], axis=0)
        return out.astype(dtype) if dtype is not None else out

    def _norm_rows(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        if rows.dtype == bool:
            if rows.shape[0] != self.shape[0]:
                raise IndexError(
                    f"boolean mask of length {rows.shape[0]} over "
                    f"{self.shape[0]} rows")
            rows = np.nonzero(rows)[0]
        rows = rows.astype(np.int64)
        n = self.shape[0]
        rows = np.where(rows < 0, rows + n, rows)
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(
                f"row index out of range for {n}-row embedding view")
        return rows

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        out = np.empty((rows.shape[0], self.shape[1]), self.dtype)
        lo = 0
        for p in self.parts:
            hi = lo + p.shape[0]
            m = (rows >= lo) & (rows < hi)
            if m.any():
                out[m] = np.asarray(p[rows[m] - lo])
            lo = hi
        return out

    def take(self, rows) -> np.ndarray:
        """Gather arbitrary rows (int array or boolean mask); reads only
        the requested rows from each shard. Negative indices wrap and
        out-of-range ones raise, matching ndarray semantics."""
        return self._gather(self._norm_rows(rows))

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.take(np.asarray([key]))[0]
        if isinstance(key, slice):
            return self.take(np.arange(*key.indices(self.shape[0])))
        return self.take(key)


class QuantizedShardedEmbeddings(ShardedEmbeddings):
    """Lazy view over int8 shards + per-row scales.

    Float consumers (index builders, dedup, benchmarks) see dequantized
    f32 through every inherited accessor (``take`` / slicing /
    ``iter_shards`` / ``np.asarray``), so a quantized store drops into
    any code written for float views. The quantized serving path reads
    the raw parts instead: ``iter_qshards()`` / ``take_q()`` hand
    (int8 values, f32 scales) to the device cache so only stored bytes
    ever cross the host→device link (core/index.DeviceStore)."""

    is_quantized = True

    def __init__(self, parts: List[np.ndarray], scales: List[np.ndarray],
                 dim: int):
        super().__init__(parts, dim, np.float32)   # consumers see f32
        self.scales = scales
        self.qdtype = np.dtype(np.int8)

    def iter_qshards(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        yield from zip(self.parts, self.scales)

    def iter_shards(self) -> Iterator[np.ndarray]:
        for p, s in zip(self.parts, self.scales):
            yield dequantize_rows(np.asarray(p), np.asarray(s))

    def __array__(self, dtype=None, copy=None):
        if not self.parts:
            return np.zeros(self.shape, dtype or self.dtype)
        out = np.concatenate(list(self.iter_shards()), axis=0)
        return out.astype(dtype) if dtype is not None else out

    def _gather_q(self, rows: np.ndarray):
        vals = np.empty((rows.shape[0], self.shape[1]), np.int8)
        scale = np.empty((rows.shape[0],), np.float32)
        lo = 0
        for p, s in zip(self.parts, self.scales):
            hi = lo + p.shape[0]
            m = (rows >= lo) & (rows < hi)
            if m.any():
                local = rows[m] - lo
                vals[m] = np.asarray(p[local])
                scale[m] = np.asarray(s[local])
            lo = hi
        return vals, scale

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        return dequantize_rows(*self._gather_q(rows))

    def take_q(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Raw row gather: (int8 values (n, d), f32 scales (n,))."""
        return self._gather_q(self._norm_rows(rows))


# backward-compat flag so callers can branch without isinstance checks
ShardedEmbeddings.is_quantized = False


class PrecomputedStore:
    def __init__(self, root, dim: int, emb_dtype="float16",
                 shard_rows: int = SHARD_ROWS):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.dim = dim
        self.emb_dtype = np.dtype(emb_dtype)
        self.shard_rows = shard_rows
        self.count = 0
        self.shards: List[dict] = []
        self.manifest_extra: dict = {}
        # "w+": this is the CREATE path — a build killed before its first
        # flush leaves a dirty text.jsonl with no manifest, and appending
        # after those orphans would bake dead rows into the fresh store
        # (reopen-for-append goes through open_, which truncates to the
        # committed watermark instead)
        self._text_f = open(self.root / "text.jsonl", "w+", encoding="utf-8")
        self._offsets: List[int] = []
        self._pending_embs: List[np.ndarray] = []
        # int8 stores: per-row scales parallel to _pending_embs (which then
        # holds already-quantized int8 batches — per-row quantization is
        # batching-independent, so quantize-at-ingest == quantize-on-flush)
        self._pending_scales: List[np.ndarray] = []
        self._pending_rows = 0
        # one shared file handle: seek+read / seek+write must be atomic
        self._lock = threading.Lock()

    @property
    def quantized(self) -> bool:
        return self.emb_dtype == np.int8

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Flush pending rows + manifest and release the text file handle.

        Idempotent; the store is unusable for reads/writes afterwards.
        """
        if self._text_f is not None and not self._text_f.closed:
            self.flush()
            self._text_f.close()

    def abort(self):
        """Release the text handle WITHOUT committing pending state —
        crash semantics for a failed build: the store on disk stays at
        its last flushed checkpoint, and a later ``open_`` truncates any
        uncommitted tail exactly as it would after a real kill."""
        if self._text_f is not None and not self._text_f.closed:
            self._text_f.close()

    @property
    def closed(self) -> bool:
        return self._text_f is None or self._text_f.closed

    def __enter__(self) -> "PrecomputedStore":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- write path ---------------------------------------------------------
    def add_batch(self, embs: np.ndarray, queries: Sequence[str],
                  responses: Sequence[str]):
        assert embs.shape == (len(queries), self.dim)
        with self._lock:
            self._text_f.seek(0, 2)
            for q, r in zip(queries, responses):
                self._offsets.append(self._text_f.tell())
                self._text_f.write(json.dumps({"q": q, "r": r}) + "\n")
            if self.quantized:
                qv, sc = quantize_rows(embs)
                self._pending_embs.append(qv)
                self._pending_scales.append(sc)
            else:
                self._pending_embs.append(embs.astype(self.emb_dtype))
            self._pending_rows += len(queries)
            self.count += len(queries)
            while self._pending_rows >= self.shard_rows:
                self._flush_shard(self.shard_rows)

    def _flush_shard(self, rows):
        buf = np.concatenate(self._pending_embs, axis=0)
        shard, rest = buf[:rows], buf[rows:]
        self._pending_embs = [rest] if len(rest) else []
        self._pending_rows = len(rest)
        name = f"emb_{len(self.shards):04d}.npy"
        # tmp + rename: a partial tail shard is REWRITTEN under the same
        # name on later flushes, and the committed manifest may already
        # reference it — a torn overwrite would corrupt the store
        self._atomic_npy(name, shard)
        entry = {"file": name, "rows": int(shard.shape[0])}
        if self.quantized:
            sbuf = np.concatenate(self._pending_scales)
            sshard, srest = sbuf[:rows], sbuf[rows:]
            self._pending_scales = [srest] if len(srest) else []
            sname = f"emb_{len(self.shards):04d}_scale.npy"
            self._atomic_npy(sname, sshard)
            entry["scale_file"] = sname
        self.shards.append(entry)

    def flush(self):
        with self._lock:
            if self._pending_rows:
                # merge pending rows into a trailing partial shard first:
                # checkpoint-heavy builds flush often, and cutting a tiny
                # shard per flush would fragment a paper-scale store into
                # hundreds of files. This keeps the layout a pure function
                # of the row count: full shards plus at most one tail.
                if self.shards and self.shards[-1]["rows"] < self.shard_rows:
                    last = self.shards.pop()
                    prev = np.load(self.root / last["file"])
                    self._pending_embs.insert(0, prev)
                    if self.quantized:
                        # per-row scales merge by plain concat — no
                        # dequant/requant, so the merged shard is byte-
                        # identical to one written in a single flush
                        self._pending_scales.insert(
                            0, np.load(self.root / last["scale_file"]))
                    self._pending_rows += last["rows"]
                while self._pending_rows >= self.shard_rows:
                    self._flush_shard(self.shard_rows)
                if self._pending_rows:
                    self._flush_shard(self._pending_rows)
            self._text_f.flush()
            text_bytes = os.fstat(self._text_f.fileno()).st_size
            # atomic commits (tmp + rename): a kill mid-flush leaves either
            # the old or the new file, never a torn one — that's what makes
            # resumable builds safe to restart from the manifest
            self._atomic_npy("offsets.npy",
                             np.asarray(self._offsets, np.int64))
            manifest = {"dim": self.dim, "count": self.count,
                        "emb_dtype": str(self.emb_dtype),
                        "shard_rows": self.shard_rows,
                        "text_bytes": text_bytes,
                        "shards": self.shards,
                        "extra": self.manifest_extra}
            tmp = self.root / "manifest.json.tmp"
            tmp.write_text(json.dumps(manifest))
            os.replace(tmp, self.root / "manifest.json")

    def _atomic_npy(self, name: str, arr: np.ndarray):
        tmp = self.root / (name + ".tmp.npy")
        np.save(tmp, arr)
        os.replace(tmp, self.root / name)

    # -- read path ------------------------------------------------------------
    @classmethod
    def open_(cls, root) -> "PrecomputedStore":
        root = Path(root)
        man = json.loads((root / "manifest.json").read_text())
        st = cls.__new__(cls)
        st.root = root
        st.dim = man["dim"]
        st.emb_dtype = np.dtype(man["emb_dtype"])
        st.shard_rows = man.get("shard_rows", SHARD_ROWS)
        st.count = man["count"]
        st.shards = man["shards"]
        st.manifest_extra = man.get("extra", {})
        # offsets may be one flush ahead of the manifest if a writer was
        # killed between the two renames — the manifest count is the commit
        # point, so drop any rows past it
        st._offsets = np.load(root / "offsets.npy").tolist()[:st.count]
        # "a+" (not "r"): a reopened store must keep serving appends —
        # §3.1 add_misses writes back into a store opened for reading.
        st._text_f = open(root / "text.jsonl", "a+", encoding="utf-8")
        text_bytes = man.get("text_bytes")
        if text_bytes is not None:
            st._text_f.seek(0, 2)
            if st._text_f.tell() > text_bytes:
                # trailing rows a killed writer appended but never committed
                st._text_f.truncate(text_bytes)
        st._pending_embs, st._pending_rows = [], 0
        st._pending_scales = []
        st._lock = threading.Lock()
        return st

    def embeddings(self, mmap: bool = True):
        """All embeddings, (count, dim): flushed shards plus pending rows.

        ``mmap=True`` (default) returns a zero-copy ``ShardedEmbeddings``
        view over the per-shard memmaps — nothing is materialized in RAM
        until a caller asks for rows. ``mmap=False`` returns a plain
        materialized ndarray. Quantized stores return a
        ``QuantizedShardedEmbeddings`` view (f32 on access, raw int8 +
        scales via its ``*_q`` accessors); ``mmap=False`` dequantizes.
        """
        mode = "r" if mmap else None
        parts = [np.load(self.root / s["file"], mmap_mode=mode)
                 for s in self.shards]
        if self._pending_embs:
            parts += self._pending_embs
        if self.quantized:
            scales = [np.load(self.root / s["scale_file"], mmap_mode=mode)
                      for s in self.shards] + self._pending_scales
            view = QuantizedShardedEmbeddings(parts, scales, self.dim)
            if not parts:
                return np.zeros((0, self.dim), np.float32)
            return view if mmap else np.asarray(view)
        if not parts:
            return np.zeros((0, self.dim), self.emb_dtype)
        if mmap:
            return ShardedEmbeddings(parts, self.dim, self.emb_dtype)
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    def get_pair(self, row: int) -> Tuple[str, str]:
        with self._lock:
            self._text_f.seek(self._offsets[row])
            line = self._text_f.readline()
        d = json.loads(line)
        return d["q"], d["r"]

    def get_response(self, row: int) -> str:
        return self.get_pair(row)[1]

    # -- accounting -----------------------------------------------------------
    def storage_bytes(self) -> dict:
        index_b = sum((self.root / s["file"]).stat().st_size
                      + ((self.root / s["scale_file"]).stat().st_size
                         if "scale_file" in s else 0)
                      for s in self.shards)
        text_p = self.root / "text.jsonl"
        off_p = self.root / "offsets.npy"
        meta_b = (text_p.stat().st_size if text_p.exists() else 0) \
            + (off_p.stat().st_size if off_p.exists() else 0)
        return {"index_bytes": index_b, "metadata_bytes": meta_b,
                "total_bytes": index_b + meta_b, "rows": self.count}
