"""MIPS index tiers over the precomputed-query embeddings, on a device.

Port of the JAX package's ``core/index.py`` serving tiers:

  FlatIndex  — exact MIPS over a device-resident copy (``DeviceStore``):
               uploaded once, §3.1 write-back rebuilds append only the new
               rows, scanned by the ``mips_topk`` / ``mips_topk_int8``
               kernels on CUDA.
  IVFIndex   — k-means coarse quantizer, probes ``nprobe`` lists of a
               padded (lists, cap, dim) f32 layout; ``save``/``load`` keep
               the reference's ``index_ivf.npz`` format (centroids + padded
               ids + a crc32 fingerprint of the first rows), so a fit
               written by either package opens in the other.

  ShardedIndex — exact MIPS over a mesh (``launch/mesh.py``): rows split
               over the mesh's ``shard_axis``, each shard scanned locally
               (the ``mips_topk`` kernel on CUDA for float stores, a plain
               product for int8 ones), a top-k over the gathered
               candidates (``distributed/topk.py``).

``auto_index`` picks among them from the store size and the mesh
(``select_tier``: sharded from ``shard_min_rows`` rows when the mesh's
shard axis is above 1); ``cache_dir=`` loads a matching persisted IVF fit
instead of re-running k-means. ``IncrementalIndex`` is the offline
build's dedup index: an append-only device buffer, flat below
``flat_max_rows`` and IVF above it.

Residency layout of a ``DeviceStore`` (``layout=``):

* ``"kernel"`` (default on CUDA) — rows stay in their stored dtype: int8
  values + per-row f32 scales for quantized stores, scanned by the
  ``mips_topk_int8`` kernel with the query block quantized the same way;
  fp16/fp32 rows otherwise, scanned by ``mips_topk``.
* ``"gemm"`` (default on CPU, and only there) — rows are dequantized /
  upcast once at upload into a transposed (D, N) fp32 matrix, scanned by
  ``torch.matmul`` and a first-occurrence top-k, as the reference does on
  CPU. A CUDA device refuses it: there the kernels scan.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
import zipfile
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.store import quantize_rows
from repro_torch.distributed.sharding import shard
from repro_torch.distributed.topk import sharded_mips_topk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_by_value

# Below this row count an exact flat scan beats any pruning; above it the
# reference picks IVF (the paper's 150K-pair store lands there).
FLAT_MAX_ROWS = 32768
SHARD_MIN_ROWS = 4 * FLAT_MAX_ROWS
# rows gathered to the host per DeviceStore.sync step (bounds peak host
# memory during the initial upload of a paper-scale store)
_SYNC_ROWS = 65536


def exact_fp32():
    """Keep CUDA matmuls and convolutions in full f32, as the reference
    computes: TF32 keeps ~3 decimal digits, which would move the engine's
    logits and the dedup scores that sit on a 0.99 threshold. Set where
    the facade, the offline pipeline and the dedup index enter the CUDA
    path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _default_layout(device: torch.device) -> str:
    return "kernel" if device.type == "cuda" else "gemm"


class DeviceStore:
    """Device-resident copy of a store's embeddings: upload once, append
    deltas, scan without ever re-shipping N×D. ``uploads`` counts
    host→device transfers; ``search`` is exact over what is resident."""

    def __init__(self, source, layout: str = "auto", device="cuda"):
        self.device = torch.device(device)
        if layout == "auto":
            layout = _default_layout(self.device)
        if layout not in ("kernel", "gemm"):
            raise ValueError(f"unknown DeviceStore layout {layout!r}")
        if layout == "gemm" and self.device.type == "cuda":
            raise ValueError("the gemm layout is the CPU's; a CUDA device "
                             "scans with the mips_topk kernels (layout "
                             "'kernel')")
        self.layout = layout
        self.n_rows = 0
        self.dim: Optional[int] = None
        self.quantized = False
        self._xT = None        # gemm: (D, N) f32
        self._x = None         # kernel: (N, D) stored dtype
        self._scales = None    # kernel + quantized: (N,) f32
        self.uploads = 0
        # background §3.1 rebuilds sync() deltas while the serving path
        # searches the SAME cached residency — the lock keeps the
        # (_x, _scales, n_rows) triple consistent across that race
        self._sync_lock = threading.Lock()
        self.sync(source)

    @staticmethod
    def _view(source):
        return source.embeddings() if hasattr(source, "embeddings") \
            else source

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def sync(self, source) -> "DeviceStore":
        """Ingest rows the device copy doesn't have yet (the §3.1
        write-back delta); a no-op when the store hasn't grown."""
        with self._sync_lock:
            return self._sync_locked(source)

    def _sync_locked(self, source) -> "DeviceStore":
        view = self._view(source)
        n, d = int(view.shape[0]), int(view.shape[1])
        if self.dim is None:
            self.dim = d
        elif d != self.dim:
            raise ValueError(f"dim changed {self.dim} -> {d}")
        if n < self.n_rows:
            raise ValueError(
                f"store shrank ({self.n_rows} -> {n} rows): DeviceStore "
                "deltas are append-only — build a fresh one")
        if n == self.n_rows:
            return self
        quantized = bool(getattr(view, "is_quantized", False))
        if self.n_rows == 0:
            self.quantized = quantized
        elif quantized != self.quantized:
            raise ValueError("store changed quantization mid-flight")

        def gather(rows):
            # view.take gathers ROWS on shard views; ndarray.take would
            # gather flat elements, so plain arrays index instead
            return view.take(rows) if hasattr(view, "iter_shards") \
                else np.asarray(view[rows])

        chunks = [np.arange(lo, min(lo + _SYNC_ROWS, n))
                  for lo in range(self.n_rows, n, _SYNC_ROWS)]
        if self.layout == "gemm":
            parts = [self._put(gather(c).astype(np.float32).T)
                     for c in chunks]
            parts = ([] if self._xT is None else [self._xT]) + parts
            self._xT = torch.cat(parts, dim=1)
        elif self.quantized:
            got = [view.take_q(c) for c in chunks]
            xs = ([] if self._x is None else [self._x]) \
                + [self._put(v) for v, _ in got]
            ss = ([] if self._scales is None else [self._scales]) \
                + [self._put(s) for _, s in got]
            self._x = torch.cat(xs, dim=0)
            self._scales = torch.cat(ss, dim=0)
        else:
            xs = ([] if self._x is None else [self._x]) \
                + [self._put(gather(c)) for c in chunks]
            self._x = torch.cat(xs, dim=0)
        self.uploads += len(chunks)
        self.n_rows = n
        return self

    def matrix(self) -> torch.Tensor:
        """The resident rows as a device (N, D) f32 matrix (an IVF fit over
        a store that outgrew the flat tier reuses the residency instead of
        re-uploading)."""
        with self._sync_lock:
            n_rows, xT, x, scales = (self.n_rows, self._xT, self._x,
                                     self._scales)
        if n_rows == 0:
            return torch.zeros((0, self.dim or 0), dtype=torch.float32,
                               device=self.device)
        if self.layout == "gemm":
            return xT.T
        x = x.float()
        return x * scales[:, None] if self.quantized else x

    def search(self, queries, k: int):
        """Exact flat MIPS over the resident rows: (vals, idx) ndarrays."""
        q = np.asarray(queries, np.float32)
        k = int(k)
        with self._sync_lock:      # consistent (operand, scales, n) triple
            n_rows = self.n_rows
            xT, x, scales = self._xT, self._x, self._scales
        if k > n_rows:
            raise ValueError(f"k={k} exceeds store rows N={n_rows}")
        if self.layout == "gemm":
            v, i = topk_by_value(self._put(q) @ xT, k)
        elif self.quantized:
            q8, qs = quantize_rows(q)
            v, i = ops.mips_topk_int8(self._put(q8), self._put(qs), x,
                                      scales, k)
        else:
            v, i = ops.mips_topk(self._put(q), x, k)
        return v.cpu().numpy(), i.cpu().numpy()


# One DeviceStore per live store object: index rebuilds (write-backs) get
# the cached residency + a delta sync instead of a re-upload.
_DEVICE_STORES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_device_store(store, device=None) -> Optional[DeviceStore]:
    """The store's cached ``DeviceStore`` if one already exists (on
    ``device``, when given), delta-synced — or None, WITHOUT creating
    residency. IVF fits use it: a store that grew out of the flat tier
    reuses the residency it already paid for, but an IVF-scale store never
    pins a flat device copy just to seed k-means."""
    try:
        ds = _DEVICE_STORES.get(store)
    except TypeError:
        return None
    if ds is None or (device is not None
                      and ds.device != torch.device(device)):
        return None
    return ds.sync(store)


def device_store_for(store, layout: str = "auto",
                     device="cuda") -> DeviceStore:
    """The per-store cached ``DeviceStore`` (created on first use, delta-
    synced on every later call). Non-store sources (raw arrays, bare
    views) get a fresh uncached instance. A cached entry is only reused
    when its device and layout match."""
    device = torch.device(device)
    if layout == "auto":
        layout = _default_layout(device)
    if not hasattr(store, "embeddings"):
        return DeviceStore(store, layout=layout, device=device)
    try:
        cached = _DEVICE_STORES.get(store)
    except TypeError:
        cached = None
    if cached is not None and cached.layout == layout \
            and cached.device == device:
        return cached.sync(store)
    ds = DeviceStore(store, layout=layout, device=device)
    try:
        _DEVICE_STORES[store] = ds
    except TypeError:
        pass
    return ds


class FlatIndex:
    """Exact MIPS over a device-resident copy of the embeddings
    (``DeviceStore``). ``use_kernel`` forces the kernel layout (the plain
    versions of the kernels on CPU); the default picks per device, and a
    CUDA device always scans with the kernels."""

    def __init__(self, embs=None, use_kernel: bool = False,
                 device: Optional[DeviceStore] = None, on="cuda"):
        if device is None:
            device = DeviceStore(embs,
                                 layout="kernel" if use_kernel else "auto",
                                 device=on)
        self.dev = device
        self.use_kernel = use_kernel or device.layout == "kernel"

    def search(self, queries: np.ndarray, k: int):
        return self.dev.search(queries, k)

    def __len__(self):
        return self.dev.n_rows


# ---------------------------------------------------------------------------
# IVF (k-means coarse quantizer)
# ---------------------------------------------------------------------------

# transient bytes of one chunk of the probe gather (Q, nprobe, cap, D) f32;
# queries are scanned in chunks that stay under it (the result is the same)
_PROBE_CHUNK_BYTES = 512 * 2 ** 20


def _device_matrix(embs, device) -> torch.Tensor:
    """Host -> device (N, D) f32, one shard at a time in its STORED dtype
    (fp16 halves the transfer, int8 + scales quarter it), upcast or
    dequantized on the device: peak host memory is one shard."""
    device = torch.device(device)

    def put(a):   # a memmapped shard is read-only: copy it
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(
            device)

    if hasattr(embs, "iter_qshards"):
        parts = [put(v).float() * put(sc)[:, None]
                 for v, sc in embs.iter_qshards()]
    elif hasattr(embs, "iter_shards"):
        parts = [put(p).float() for p in embs.iter_shards()]
    else:
        return put(np.asarray(embs)).float()
    if not parts:
        return torch.zeros(embs.shape, dtype=torch.float32, device=device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def kmeans(x: torch.Tensor, n_clusters: int, iters: int = 10,
           seed: int = 0):
    """Plain Lloyd's on ``x``'s device. Returns (centroids, assignment).
    The seed rows are drawn by a seeded ``torch.Generator`` (the
    reference's ``jax.random.choice`` stream cannot be reproduced, so
    exact parity with a reference fit goes through its saved file).
    ``n_clusters`` is clamped to the row count."""
    n = int(x.shape[0])
    n_clusters = max(1, min(int(n_clusters), n))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    init = torch.randperm(n, generator=gen, device=x.device)[:n_clusters]
    cent = x[init]
    x2 = (x * x).sum(1)[:, None]
    for _ in range(iters):
        d = x2 - 2 * x @ cent.T + (cent * cent).sum(1)[None, :]
        assign = torch.argmin(d, dim=1)
        oh = torch.nn.functional.one_hot(assign, cent.shape[0]).to(x.dtype)
        sums = oh.T @ x
        counts = oh.sum(0)[:, None]
        cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                           cent)
    return cent, assign


class IVFIndex:
    """IVF-Flat: coarse k-means, probe the top-``nprobe`` lists, exact scan
    of their rows. Lists are padded to one (n_lists, cap, D) f32 layout
    (ids -1 in the padding), so a probe is one gather + batched product.

    ``save``/``load`` persist the k-means product (centroids + the padded
    id layout, no raw vectors: ``load`` re-gathers them from the store) in
    the reference's ``.npz`` format."""

    def __init__(self, embs, n_lists: int = 64, nprobe: int = 8,
                 seed: int = 0, device: Optional[DeviceStore] = None,
                 on="cuda"):
        # an ALREADY-cached DeviceStore (a store that grew out of the flat
        # tier) seeds the fit from its resident rows; otherwise the fit
        # matrix is transient, so an IVF-scale store never pins a flat copy
        x = device.matrix() if device is not None else _device_matrix(embs,
                                                                      on)
        self.n_total = int(x.shape[0])
        self.n_lists = max(1, min(n_lists, self.n_total))
        self.nprobe = min(nprobe, self.n_lists)
        self.loaded_from: Optional[str] = None
        self.centroids, assign = kmeans(x, self.n_lists, seed=seed)
        # rows grouped by list, ascending row order inside each list (the
        # reference fills its layout in that order)
        order = torch.argsort(assign, stable=True)
        lst = assign[order]
        counts = torch.bincount(assign, minlength=self.n_lists)
        cap = max(int(counts.max()), 1)
        slot = torch.arange(self.n_total, device=x.device) \
            - (torch.cumsum(counts, 0) - counts)[lst]
        self.ids = torch.full((self.n_lists, cap), -1, dtype=torch.int32,
                              device=x.device)
        self.ids[lst, slot] = order.to(torch.int32)
        self.lists = torch.zeros((self.n_lists, cap, x.shape[1]),
                                 dtype=torch.float32, device=x.device)
        self.lists[lst, slot] = x[order]

    @property
    def cap(self) -> int:
        return int(self.ids.shape[1])

    # -- persistence ----------------------------------------------------------
    @staticmethod
    def _fingerprint(lists, ids: np.ndarray) -> int:
        """crc32 of the first 256 valid rows in list-major order: the row
        count alone cannot tell a store with other content apart from the
        one the fit belongs to. ``lists`` is an array or a tensor; only
        the sampled rows leave the device."""
        first = np.flatnonzero(ids.ravel() >= 0)[:256]
        flat = lists.reshape(-1, lists.shape[-1])
        if isinstance(flat, torch.Tensor):
            flat = flat[torch.from_numpy(first).to(flat.device)].cpu().numpy()
        else:
            flat = flat[first]
        return zlib.crc32(np.ascontiguousarray(flat, np.float32).tobytes())

    def save(self, path):
        """Persist centroids + padded id layout, atomically (tmp + rename)
        so a killed build never leaves a torn cache."""
        path = Path(path)
        meta = {"n_total": self.n_total, "n_lists": self.n_lists,
                "nprobe": self.nprobe,
                "dim": int(self.centroids.shape[1]),
                "fingerprint": self._fingerprint(self.lists,
                                                 self.ids.cpu().numpy())}
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, centroids=self.centroids.cpu().numpy(),
                     ids=self.ids.cpu().numpy(),
                     meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path, embs, on="cuda") -> "IVFIndex":
        """Rebuild from a ``save``d layout + the store's embeddings (any
        array or sharded view), without k-means. Raises ``ValueError`` when
        the fingerprint says the fit belongs to other store content."""
        path = Path(path)
        with np.load(path) as d:
            meta = json.loads(bytes(d["meta"]).decode())
            centroids = d["centroids"]
            ids = d["ids"]
        valid = ids >= 0
        rows = ids[valid]
        vecs = embs.take(rows) if hasattr(embs, "iter_shards") \
            else np.asarray(embs)[rows]
        buf = np.zeros(ids.shape + (int(meta["dim"]),), np.float32)
        buf[valid] = np.asarray(vecs, np.float32)
        want = meta.get("fingerprint")
        if want is not None and cls._fingerprint(buf, ids) != want:
            raise ValueError(
                f"{path}: persisted IVF fit belongs to different store "
                "content (same row count, different vectors) — rebuild")
        st = cls.__new__(cls)
        st.n_total = int(meta["n_total"])
        st.n_lists = int(meta["n_lists"])
        st.nprobe = int(meta["nprobe"])
        st.loaded_from = str(path)
        device = torch.device(on)
        st.centroids = torch.from_numpy(centroids).to(device)
        st.ids = torch.from_numpy(ids).to(device)
        st.lists = torch.from_numpy(buf).to(device)
        return st

    # -- search ---------------------------------------------------------------
    def _search_impl(self, q: torch.Tensor, k: int):
        # 1. coarse: the nprobe best centroids, (value desc, index asc)
        _, probe = topk_by_value(q @ self.centroids.T, self.nprobe)
        probe = probe.long()
        # 2. gather the probed lists and scan them exactly, chunked over
        #    queries to bound the (Q, nprobe, cap, D) transient
        per_q = self.nprobe * self.lists.shape[1] * self.lists.shape[2] * 4
        step = max(1, _PROBE_CHUNK_BYTES // max(per_q, 1))
        vals, idx = [], []
        for lo in range(0, q.shape[0], step):
            qc, pc = q[lo:lo + step], probe[lo:lo + step]
            cand_ids = self.ids[pc].reshape(qc.shape[0], -1)
            s = torch.einsum("qd,qpcd->qpc", qc, self.lists[pc])
            s = s.reshape(qc.shape[0], -1).masked_fill(cand_ids < 0,
                                                       -float("inf"))
            v, pos = topk_by_value(s, k)
            vals.append(v)
            idx.append(torch.gather(cand_ids, 1, pos.long()))
        return torch.cat(vals), torch.cat(idx)

    def search(self, queries: np.ndarray, k: int):
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.lists.device)
        v, i = self._search_impl(q, int(k))
        return v.cpu().numpy(), i.cpu().numpy()

    def __len__(self):
        return self.n_total

    def reconstruct(self) -> np.ndarray:
        """The indexed rows, (N, D), rebuilt from the padded list layout
        (row order restored from the stored ids)."""
        lists = self.lists.cpu().numpy()
        ids = self.ids.cpu().numpy()
        out = np.zeros((self.n_total, lists.shape[-1]), np.float32)
        valid = ids >= 0
        out[ids[valid]] = lists[valid]
        return out

    def recall_vs_flat(self, queries, k: int = 10) -> float:
        """Mean recall@k of this index against an exact flat scan over the
        same rows (built on demand from ``reconstruct()``, on the same
        device, and dropped). 1.0: the nprobe pruning lost nothing for
        these queries."""
        q = np.asarray(queries, np.float32)
        flat = FlatIndex(self.reconstruct(), on=self.lists.device)
        _, flat_ids = flat.search(q, k)
        _, ivf_ids = self.search(q, k)
        hits = [len(set(f.tolist()) & set(i.tolist())) / k
                for f, i in zip(flat_ids, ivf_ids)]
        return float(np.mean(hits))


class ShardedIndex:
    """Mesh-sharded exact MIPS: rows over ``shard_axis``, distributed top-k
    (``distributed/topk.py``).

    Quantized views shard the int8 values + per-row scales as they are
    stored (padded rows: zeros, scale 1); float inputs shard fp32 rows
    (padded rows: zeros). Padded rows are masked out by global row id on
    both paths (the reference masks only int8's: its float padding rows
    come back as hits, ``distributed/topk.py``). Each shard lies on its
    mesh position's device; ``search`` returns numpy (scores, GLOBAL
    ids)."""

    def __init__(self, embs, mesh, shard_axis: str = "model"):
        n_sh = mesh.shape[shard_axis]
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.scales = None
        if getattr(embs, "is_quantized", False):
            vals, scales = embs.take_q(np.arange(embs.shape[0]))
            N, D = vals.shape
            pad = (-N) % n_sh
            if pad:       # zero rows score 0; masked out via n_real
                vals = np.concatenate([vals, np.zeros((pad, D), np.int8)])
                scales = np.concatenate([scales, np.ones(pad, np.float32)])
            self.embs = shard(torch.from_numpy(np.ascontiguousarray(vals)),
                              (shard_axis,), mesh)
            self.scales = shard(torch.from_numpy(np.ascontiguousarray(
                scales, np.float32)), (shard_axis,), mesh)
        else:
            embs = np.asarray(embs)
            N, D = embs.shape
            pad = (-N) % n_sh
            if pad:
                embs = np.concatenate([embs, np.zeros((pad, D), embs.dtype)])
            self.embs = shard(torch.from_numpy(np.ascontiguousarray(
                embs, np.float32)), (shard_axis,), mesh)
        self.n_real = N

    def search(self, queries: np.ndarray, k: int):
        # one host->device copy; the shards take theirs from the device
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            self.mesh.devices.flat[0])
        v, i = sharded_mips_topk(
            q, self.embs, k, mesh=self.mesh, shard_axis=self.shard_axis,
            scales=self.scales, n_real=self.n_real)
        return v.cpu().numpy(), i.cpu().numpy()

    def __len__(self):
        return self.n_real


def select_tier(n_rows: int, mesh_axis_size: int = 1, *,
                flat_max_rows: int = FLAT_MAX_ROWS,
                shard_min_rows: int = SHARD_MIN_ROWS) -> str:
    """Pure tier decision: ``"flat" | "ivf" | "sharded"``."""
    if n_rows <= 0:
        raise ValueError("cannot index an empty store")
    if mesh_axis_size > 1 and n_rows >= shard_min_rows:
        return "sharded"
    if n_rows <= flat_max_rows:
        return "flat"
    return "ivf"


def ivf_params(n_rows: int) -> Tuple[int, int]:
    """(n_lists, nprobe) heuristic: sqrt-N lists, probe ~1/8 of them (at
    least 8) — keeps the scanned fraction roughly constant as N grows."""
    n_lists = max(16, int(round(float(n_rows) ** 0.5)))
    nprobe = max(8, n_lists // 8)
    return n_lists, min(nprobe, n_lists)


IVF_CACHE_NAME = "index_ivf.npz"


def sharded_index(embs, mesh, shard_axis: str = "model",
                  device="cuda") -> ShardedIndex:
    """``ShardedIndex`` over ``mesh``, refusing a mesh of another device
    type than ``device`` (the serving side's): the shards never run on a
    device the caller did not ask for."""
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the sharded tier runs on its mesh's devices "
                         f"({mesh.device_type}); this system asked for "
                         f"{device}")
    return ShardedIndex(embs, mesh, shard_axis=shard_axis)


def auto_index(store, mesh=None, *, shard_axis: str = "model",
               use_kernel: Optional[bool] = None,
               flat_max_rows: int = FLAT_MAX_ROWS,
               shard_min_rows: int = SHARD_MIN_ROWS, seed: int = 0,
               cache_dir=None, device="cuda"):
    """Build the right index tier for ``store`` (a PrecomputedStore, or any
    object with ``.embeddings()``, or a raw (N, D) array). ``mesh`` (a
    ``launch/mesh.Mesh``, or None for one device) gives the size of its
    ``shard_axis``: above 1 and from ``shard_min_rows`` rows the tier is
    ``ShardedIndex`` over that mesh, whose device type must be
    ``device``'s. ``use_kernel=False`` asks for the flat tier's gemm
    layout, which only a CPU device has.

    ``cache_dir`` (typically the store root) persists the IVF k-means
    product: a matching cache loads (no k-means); a stale, foreign or
    unreadable one is refitted and saved anew. The flat tier has no build
    product, so the option is a no-op there."""
    embs = store.embeddings() if hasattr(store, "embeddings") \
        else np.asarray(store, np.float32)
    n_rows = int(embs.shape[0])
    axis_size = 1
    if mesh is not None:
        try:
            axis_size = int(mesh.shape[shard_axis])
        except (KeyError, TypeError):
            axis_size = 1
    tier = select_tier(n_rows, axis_size, flat_max_rows=flat_max_rows,
                       shard_min_rows=shard_min_rows)
    is_store = hasattr(store, "embeddings")
    if tier == "sharded":
        return sharded_index(embs, mesh, shard_axis=shard_axis,
                             device=device)
    if tier == "ivf":
        n_lists, nprobe = ivf_params(n_rows)
        cache = Path(cache_dir) / IVF_CACHE_NAME if cache_dir else None
        if cache is not None and cache.exists():
            try:
                # the meta alone first, so a stale fit skips the row gather
                with np.load(cache) as d:
                    meta = json.loads(bytes(d["meta"]).decode())
                if (meta["n_total"], meta["n_lists"], meta["nprobe"]) == \
                        (n_rows, n_lists, nprobe):
                    return IVFIndex.load(cache, embs, on=device)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile):
                pass              # unreadable or foreign cache: refit
        dev = cached_device_store(store, device) if is_store else None
        idx = IVFIndex(embs, n_lists=n_lists, nprobe=nprobe, seed=seed,
                       device=dev, on=device)
        if cache is not None:
            idx.save(cache)
        return idx
    layout = "auto" if use_kernel is None else \
        ("kernel" if use_kernel else "gemm")
    dev = device_store_for(store, layout=layout, device=device) \
        if is_store else DeviceStore(embs, layout=layout, device=device)
    return FlatIndex(device=dev, use_kernel=dev.layout == "kernel")


# ---------------------------------------------------------------------------
# Incremental dedup index (the offline build)
# ---------------------------------------------------------------------------

# rows per block of the row -> list assignment product: every block has
# this one shape (the last one zero-padded), so a row's list is the same
# however the rows were batched into adds. A product of another row count
# may take another GEMM kernel, and with it another summation order, which
# could flip a near tie and break a resumed build's byte identity.
_ASSIGN_ROWS = 1024


class IncrementalIndex:
    """Append-only max-similarity index for the offline dedup loop (§3.2 at
    paper scale): ``add(embs)`` + ``max_sim(queries)``, rows in one f32
    buffer on ``device``.

    * **flat** (<= ``flat_max_rows``): ``max_sim`` is one product against
      the whole amortized-doubling buffer, exact.
    * **ivf** (above it): each row is assigned to its max-inner-product
      centroid; ``max_sim`` probes the top-``nprobe`` lists of each query.
      Assignment and probing share the metric, so an exact duplicate
      always probes the list that holds its twin.

    Centroids are refit (the port's ``kmeans`` over all rows so far, on
    the device) whenever the row count crosses ``flat_max_rows * 2^k``. In
    the default deterministic mode ``add`` splits batches exactly at those
    thresholds, and the assignment product has a fixed shape, so the index
    state is a pure function of the row sequence: a resumed build that
    re-adds the store shard by shard rebuilds the uninterrupted build's
    index bit for bit. ``background=True`` refits in a thread instead,
    giving that up. The port of the JAX package's ``IncrementalIndex``
    (whose k-means seeding draws from ``jax.random``, so the two agree bit
    for bit only in flat mode).
    """

    def __init__(self, dim: int, *, flat_max_rows: int = FLAT_MAX_ROWS,
                 probe_frac: float = 1 / 16, seed: int = 0,
                 background: bool = False, device="cuda"):
        self.dim = dim
        self.flat_max_rows = flat_max_rows
        self.probe_frac = probe_frac
        self.seed = seed
        self.background = background
        self.device = torch.device(device)
        if self.device.type == "cuda":
            exact_fp32()
        self._buf = torch.empty((1024, dim), dtype=torch.float32,
                                device=self.device)
        # each row's list (ivf mode): the ragged lists of the reference
        self._list = torch.zeros(1024, dtype=torch.long, device=self.device)
        self._n = 0
        self._next_refit = flat_max_rows
        self.centroids: Optional[torch.Tensor] = None   # (L, D) in ivf mode
        self._lock = threading.Lock()
        self._refit_thread: Optional[threading.Thread] = None
        self.refits = 0
        self.refit_seconds: List[float] = []   # wall time of each refit

    def __len__(self) -> int:
        return self._n

    @property
    def mode(self) -> str:
        return "flat" if self.centroids is None else "ivf"

    @property
    def n_lists(self) -> int:
        return 0 if self.centroids is None else int(self.centroids.shape[0])

    @property
    def nprobe(self) -> int:
        """Duplicates share their twin's top-1 list by construction (same
        inner-product metric for assignment and probing), so a thin probe
        fan suffices for dedup — min 4 lists for near-boundary cases."""
        n_lists = self.n_lists
        return max(1, min(n_lists,
                          max(4, int(round(n_lists * self.probe_frac)))))

    def assignment(self) -> np.ndarray:
        """Each row's list (ivf mode), as a host array."""
        with self._lock:
            return self._list[:self._n].cpu().numpy()

    def _put(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.to(self.device)

    # -- append ---------------------------------------------------------------
    def add(self, embs: np.ndarray):
        embs = self._put(embs)
        if embs.ndim == 1:
            embs = embs[None, :]
        if self.background:
            self._append(embs)
            if self._n >= self._next_refit and (
                    self._refit_thread is None
                    or not self._refit_thread.is_alive()):
                self._next_refit *= 2
                self._refit_thread = threading.Thread(
                    target=self._refit, daemon=True)
                self._refit_thread.start()
            return
        # deterministic mode: split the batch at refit thresholds so the
        # fit always sees exactly `threshold` rows, however adds arrive
        while len(embs):
            room = self._next_refit - self._n
            head, embs = embs[:room], embs[room:]
            self._append(head)
            if self._n == self._next_refit:
                self._refit()
                self._next_refit *= 2

    def _grow(self, need: int):
        cap = self._buf.shape[0]
        if self._n + need <= cap:
            return
        while cap < self._n + need:
            cap *= 2
        buf = torch.empty((cap, self.dim), dtype=torch.float32,
                          device=self.device)
        buf[:self._n] = self._buf[:self._n]
        lists = torch.zeros(cap, dtype=torch.long, device=self.device)
        lists[:self._n] = self._list[:self._n]
        self._buf, self._list = buf, lists

    def _assign(self, x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
        """Max-inner-product list of each row of ``x``, in fixed-shape
        blocks of ``_ASSIGN_ROWS`` rows."""
        out = []
        for lo in range(0, x.shape[0], _ASSIGN_ROWS):
            blk = x[lo:lo + _ASSIGN_ROWS]
            n = blk.shape[0]
            if n < _ASSIGN_ROWS:
                blk = torch.nn.functional.pad(blk, (0, 0, 0,
                                                    _ASSIGN_ROWS - n))
            out.append(torch.argmax(blk @ cent.T, dim=1)[:n])
        return torch.cat(out)

    def _append(self, embs: torch.Tensor):
        with self._lock:
            self._grow(len(embs))
            lo, hi = self._n, self._n + len(embs)
            self._buf[lo:hi] = embs
            if self.centroids is not None:
                self._list[lo:hi] = self._assign(embs, self.centroids)
            self._n = hi

    def _refit(self):
        """K-means over all rows so far; reassign every row. In background
        mode the fit runs without the lock (appends continue against the
        old centroids) and only the swap is locked."""
        t0 = time.perf_counter()
        with self._lock:
            n0 = self._n
            x = self._buf[:n0].clone() if self.background \
                else self._buf[:n0]
        n_lists, _ = ivf_params(n0)
        cent, _ = kmeans(x, n_lists, seed=self.seed)
        with self._lock:
            # re-assign by max inner product (the probe metric) so a row
            # is always found in the list its duplicates will probe first
            n = self._n
            self._list[:n] = self._assign(self._buf[:n], cent)
            self.centroids = cent
            self.refits += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.refit_seconds.append(time.perf_counter() - t0)

    def drain(self):
        """Join an in-flight background refit (no-op otherwise)."""
        if self._refit_thread is not None:
            self._refit_thread.join()

    # -- query ----------------------------------------------------------------
    def max_sim(self, queries: np.ndarray) -> np.ndarray:
        """Max inner product of each query against every stored row
        (-inf when empty), as a host array. Exact in flat mode;
        nprobe-approximate in ivf."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        with self._lock:
            n = self._n
            if n == 0:
                return np.full(q.shape[0], -np.inf, np.float32)
            qt = self._put(q)
            if self.centroids is None:
                return (qt @ self._buf[:n].T).amax(dim=1).cpu().numpy()
            _, probes = torch.topk(qt @ self.centroids.T, self.nprobe,
                                   dim=1)
            probed = torch.zeros((q.shape[0], self.n_lists), dtype=torch.bool,
                                 device=self.device)
            probed.scatter_(1, probes, True)
            # the rows of every probed list, each list gathered ONCE per
            # call and scanned as one product against every query, masked
            # to the lists each query probes
            lists = self._list[:n]
            rows = torch.nonzero(probed.any(dim=0)[lists])[:, 0]
            s = qt @ self._buf[rows].T
            s = s.masked_fill(~probed[:, lists[rows]], -float("inf"))
            out = s.amax(dim=1) if rows.numel() else \
                torch.full((q.shape[0],), -float("inf"), device=self.device)
            return out.cpu().numpy()
