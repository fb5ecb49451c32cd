"""The flat MIPS tier over the precomputed-query embeddings, on a device.

Port of the JAX package's ``core/index.py`` flat tier: the store's
embeddings are uploaded once to a device (``DeviceStore``), §3.1
write-back rebuilds append only the new rows, and ``FlatIndex`` scans them
exactly. The IVF and sharded tiers are not ported yet (ROADMAP A5 / A8):
``auto_index`` raises when ``select_tier`` picks one of them and never
serves flat in their place.

Residency layout per device (``layout=``):

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

import threading
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core.store import quantize_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_by_value

# Below this row count an exact flat scan beats any pruning; above it the
# reference picks IVF (the paper's 150K-pair store lands there).
FLAT_MAX_ROWS = 32768
SHARD_MIN_ROWS = 4 * FLAT_MAX_ROWS
# rows gathered to the host per DeviceStore.sync step (bounds peak host
# memory during the initial upload of a paper-scale store)
_SYNC_ROWS = 65536


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


def cached_device_store(store) -> Optional[DeviceStore]:
    """The store's cached ``DeviceStore`` if one already exists, delta-
    synced — or None, WITHOUT creating residency."""
    try:
        ds = _DEVICE_STORES.get(store)
    except TypeError:
        return None
    return ds.sync(store) if ds is not None else None


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


def auto_index(store, mesh=None, *, use_kernel: Optional[bool] = None,
               flat_max_rows: int = FLAT_MAX_ROWS,
               shard_min_rows: int = SHARD_MIN_ROWS, device="cuda"):
    """Build the right index tier for ``store`` (a PrecomputedStore, or any
    object with ``.embeddings()``, or a raw (N, D) array). Only the flat
    tier is ported: a store that ``select_tier`` puts in the IVF or
    sharded tier raises ``NotImplementedError`` instead of being served
    flat. ``mesh`` is the number of ranks the rows would shard over (the
    JAX mesh axis size; None for one device). ``use_kernel=False`` asks
    for the gemm layout, which only a CPU device has."""
    embs = store.embeddings() if hasattr(store, "embeddings") \
        else np.asarray(store, np.float32)
    n_rows = int(embs.shape[0])
    tier = select_tier(n_rows, int(mesh or 1), flat_max_rows=flat_max_rows,
                       shard_min_rows=shard_min_rows)
    if tier != "flat":
        item = "A5 (IVF tier)" if tier == "ivf" else "A8 (sharded tier)"
        raise NotImplementedError(
            f"select_tier picked the {tier!r} tier for {n_rows} rows; the "
            f"port serves only the flat tier so far (ROADMAP {item}). Pass "
            "index='flat' to scan the whole store exactly.")
    layout = "auto" if use_kernel is None else \
        ("kernel" if use_kernel else "gemm")
    dev = device_store_for(store, layout=layout, device=device) \
        if hasattr(store, "embeddings") \
        else DeviceStore(embs, layout=layout, device=device)
    return FlatIndex(device=dev, use_kernel=dev.layout == "kernel")
