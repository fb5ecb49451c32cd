"""One front door: the ``StorInfer`` system facade of the PyTorch port
(port of the JAX package's ``api.py``, serving side).

    from repro_torch import StorInfer, SystemCfg, EngineCfg

    cfg = SystemCfg(index="flat", engine=EngineCfg(smoke=False))
    with StorInfer.open("runs/demo", cfg) as si:       # on cuda
        print(si.query_batch(["what is the height of aurora bridge?"]))

Everything runs on ``cfg.device`` ("cuda" unless the caller passes
"cpu"): the device-resident index and the fallback engine. Underneath,
the duck types are checked ``Protocol``s (``EmbedderProtocol``,
``IndexProtocol``) and components are resolved from string registries
(``EMBEDDERS``: ``"hash"``; ``INDEXES``: ``"auto"``, ``"flat"``,
``"none"``).

Lifecycle:

    StorInfer.open(path, cfg)        online: store + index (+ engine when
                                     ``cfg.engine`` is set, or ``engine=``)
    .query() / .query_batch()        sequential race / batched microbatch
    .serve() / .submit()             stage-decoupled serving pipeline
    .stats() / .close()              accounting, teardown

``StorInfer.build`` (the offline precompute) is not ported yet: it needs
``PrecomputePipeline`` and ``IncrementalIndex`` (ROADMAP A6). A store built
by the JAX package opens here unchanged (same on-disk format).
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import Future
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.index import FlatIndex, auto_index, device_store_for
from repro_torch.core.runtime import (BatchedRuntime, BatchedRuntimeCfg,
                                      QueryResult, RuntimeCfg, RuntimeStats,
                                      StorInferRuntime)
from repro_torch.core.store import PrecomputedStore
from repro_torch.core.tokenizer import Tokenizer

__all__ = [
    "EmbedderProtocol", "IndexProtocol", "register_embedder",
    "register_index", "make_embedder", "make_index", "tier_of", "EngineCfg",
    "SystemCfg", "SystemStats", "StorInfer", "QueryResult", "RuntimeStats",
]


# ---------------------------------------------------------------------------
# Component protocols
# ---------------------------------------------------------------------------


@runtime_checkable
class EmbedderProtocol(Protocol):
    """Anything that maps texts to L2-normalized ``(n, dim)`` float32."""

    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


@runtime_checkable
class IndexProtocol(Protocol):
    """One search contract for every tier: ``search(q, k)`` over an
    ``(n, dim)`` query batch returns ``(scores, ids)`` each ``(n, k)``."""

    def search(self, queries: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]: ...

    def __len__(self) -> int: ...


def tier_of(index) -> str:
    """Registry-name of an index instance (``"none"`` for store-only)."""
    if index is None:
        return "none"
    if type(index) is FlatIndex:
        return "flat"
    return type(index).__name__.lower()


# ---------------------------------------------------------------------------
# String registries
# ---------------------------------------------------------------------------

EMBEDDERS: Dict[str, Callable[..., Any]] = {}
INDEXES: Dict[str, Callable[..., Any]] = {}


def register_embedder(name: str, factory: Callable[..., Any]):
    """Register ``factory(tokenizer=None, **kw) -> EmbedderProtocol``."""
    EMBEDDERS[name] = factory
    return factory


def register_index(name: str, factory: Callable[..., Any]):
    """Register ``factory(source, device=..., **kw) -> IndexProtocol``
    where ``source`` is a store, an embeddings view, or a raw
    ``(n, dim)`` array."""
    INDEXES[name] = factory
    return factory


def make_embedder(spec: Union[str, EmbedderProtocol], *, tokenizer=None,
                  **kw) -> EmbedderProtocol:
    """Resolve a registry name (or validate an instance) to an embedder."""
    if isinstance(spec, str):
        try:
            factory = EMBEDDERS[spec]
        except KeyError:
            raise KeyError(f"unknown embedder {spec!r}; registered: "
                           f"{sorted(EMBEDDERS)}") from None
        emb = factory(tokenizer=tokenizer, **kw)
    else:
        emb = spec
    if not isinstance(emb, EmbedderProtocol):
        raise TypeError(f"{type(emb).__name__} does not satisfy "
                        "EmbedderProtocol (needs .dim and .encode)")
    return emb


def make_index(spec: Union[str, IndexProtocol], source=None,
               **kw) -> Optional[IndexProtocol]:
    """Resolve a tier name (or validate an instance) to an index over
    ``source``. ``"none"`` returns None (store-only mode)."""
    if isinstance(spec, str):
        if spec == "none":
            return None
        try:
            factory = INDEXES[spec]
        except KeyError:
            raise KeyError(f"unknown index tier {spec!r}; registered: "
                           f"{sorted(INDEXES)}") from None
        idx = factory(source, **kw)
    else:
        idx = spec
    if not isinstance(idx, IndexProtocol):
        raise TypeError(f"{type(idx).__name__} does not satisfy "
                        "IndexProtocol (needs .search and __len__)")
    return idx


def _flat_factory(source, use_kernel=False, device="cuda"):
    # stores get the per-store DeviceStore cache, so §3.1 write-back
    # rebuilds of a pinned "flat" tier append deltas instead of
    # re-uploading the matrix (auto_index does the same for "auto")
    layout = "kernel" if use_kernel else "auto"
    if hasattr(source, "embeddings"):
        return FlatIndex(device=device_store_for(source, layout=layout,
                                                 device=device),
                         use_kernel=use_kernel)
    return FlatIndex(source, use_kernel=use_kernel, on=device)


register_embedder("hash", lambda tokenizer=None, **kw: HashEmbedder(**kw))
register_index("auto", auto_index)
register_index("flat", _flat_factory)


# ---------------------------------------------------------------------------
# Declarative system configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineCfg:
    """The fallback LM behind the runtime race. ``smoke=True`` shrinks the
    arch (``configs.reduced`` + ``smoke_layers`` layers, vocab from the
    tokenizer); ``smoke=False`` serves the full arch (random weights from
    ``seed``, fp32, as the reference)."""
    arch: str = "qwen3-1.7b"
    smoke: bool = True
    smoke_layers: int = 2
    max_len: int = 160
    chunk: int = 8
    seed: int = 0


@dataclasses.dataclass
class SystemCfg:
    """Everything needed to assemble a StorInfer system, declaratively.

    ``embedder``/``index`` are registry names (or ready instances
    satisfying the protocols); ``engine=None`` runs search-only (misses
    return empty responses); ``s_th_run`` overrides the runtime threshold
    on BOTH the sequential and batched paths; ``device`` places the index
    and the engine.
    """
    embedder: Union[str, EmbedderProtocol] = "hash"
    embedder_kw: dict = dataclasses.field(default_factory=dict)
    index: Union[str, IndexProtocol] = "auto"
    index_kw: dict = dataclasses.field(default_factory=dict)
    runtime: RuntimeCfg = dataclasses.field(default_factory=RuntimeCfg)
    batched: BatchedRuntimeCfg = dataclasses.field(
        default_factory=BatchedRuntimeCfg)
    engine: Optional[EngineCfg] = None
    s_th_run: Optional[float] = None
    decode_slots: Optional[int] = None   # overrides cfg.batched's
    device: str = "cuda"

    def __post_init__(self):
        if self.s_th_run is not None:
            self.runtime = dataclasses.replace(self.runtime,
                                               s_th_run=self.s_th_run)
            self.batched = dataclasses.replace(self.batched,
                                               s_th_run=self.s_th_run)
        if self.decode_slots is not None:
            self.batched = dataclasses.replace(
                self.batched, decode_slots=self.decode_slots)


@dataclasses.dataclass
class SystemStats:
    """One accounting view over the whole system: merged runtime counters
    (sequential + batched paths), the store's storage split, which index
    tier is serving, and the staged pipeline's snapshot when it ran."""
    runtime: RuntimeStats
    store_rows: int
    store_bytes: dict
    index_tier: str
    index_rows: int
    has_engine: bool
    pipeline: Optional[dict] = None


# ---------------------------------------------------------------------------
# Assembly helpers
# ---------------------------------------------------------------------------


def _tokenizer_from_store(store, sample: int = 512):
    """Vocab for an engine opened over a bare store: built from a sample
    of the stored pairs (the store IS the corpus at serve time)."""
    texts = []
    for row in range(min(store.count, sample)):
        q, r = store.get_pair(row)
        texts += [q, r]
    return Tokenizer.from_texts(texts or ["empty"])


def _exact_fp32():
    """Keep CUDA matmuls and convolutions in full f32, as the reference
    computes: TF32 keeps ~3 decimal digits, which would move the engine's
    logits. Set once, where the facade (``StorInfer.__init__``, which
    ``open`` calls) enters the CUDA path."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _build_engine(ecfg: EngineCfg, tokenizer, device):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    cfg = get_config(ecfg.arch)
    if ecfg.smoke:
        cfg = dataclasses.replace(reduced(cfg),
                                  vocab_size=tokenizer.vocab_size,
                                  n_layers=ecfg.smoke_layers)
    gen = torch.Generator(device=device).manual_seed(ecfg.seed)
    params = M.init_model(cfg, gen, dtype=torch.float32, device=device)
    return Engine(cfg, params, tokenizer, max_len=ecfg.max_len,
                  chunk=ecfg.chunk)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


class StorInfer:
    """The StorInfer system behind one handle: store + index + embedder
    (+ optional engine), with the sequential reference runtime and the
    batched serving runtime sharing that one index.

    Construct via ``StorInfer.open`` (serve an existing store) or directly
    from ready components (protocol-checked)."""

    def __init__(self, store: PrecomputedStore, embedder, index=None, *,
                 engine=None, cfg: SystemCfg = None):
        self.store = store
        self.embedder = make_embedder(embedder)   # validates the protocol
        self.index = make_index(index) if index is not None else None
        self.engine = engine
        self.cfg = cfg or SystemCfg()
        if str(self.cfg.device).startswith("cuda") or getattr(
                getattr(engine, "device", None), "type", None) == "cuda":
            _exact_fp32()
        self._seq_stats = RuntimeStats()
        self._seq = self._batched = None
        if self.index is not None:
            self._seq = StorInferRuntime(self.index, store, self.embedder,
                                         engine, cfg=self.cfg.runtime)
            # §3.1 write-back rebuilds honor the DECLARED tier and its
            # kwargs; an instance-configured index has no recipe, so its
            # rebuilds fall back to auto_index
            rebuild = None
            if isinstance(self.cfg.index, str):
                rebuild = lambda store, mesh: make_index(   # noqa: E731
                    self.cfg.index, store, device=self.cfg.device,
                    **self.cfg.index_kw)
            self._batched = BatchedRuntime(
                self.index, store, self.embedder, engine,
                cfg=self.cfg.batched,
                auto_index_kw={"device": self.cfg.device}, rebuild=rebuild)

    # -- lifecycle ------------------------------------------------------------
    @classmethod
    def open(cls, path, cfg: SystemCfg = None, *, tokenizer=None,
             engine=None) -> "StorInfer":
        """Open an existing store for serving: memory-mapped shards, the
        index on ``cfg.device``, and the engine (``engine=``, or built
        from ``cfg.engine`` when set)."""
        cfg = cfg or SystemCfg()
        store = PrecomputedStore.open_(path)
        embedder = make_embedder(cfg.embedder, tokenizer=tokenizer,
                                 **cfg.embedder_kw)
        index = make_index(cfg.index, store, device=cfg.device,
                           **cfg.index_kw)
        if engine is None and cfg.engine is not None:
            tok = tokenizer or _tokenizer_from_store(store)
            engine = _build_engine(cfg.engine, tok, cfg.device)
        return cls(store, embedder, index, engine=engine, cfg=cfg)

    def close(self):
        """Stop serving, release runtimes, flush + close the store."""
        if self._batched is not None:
            self._batched.close()
        if self._seq is not None:
            self._seq.close()
        self.store.close()

    def __enter__(self) -> "StorInfer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- query paths ----------------------------------------------------------
    def _require_index(self, what: str):
        if self.index is None:
            raise RuntimeError(
                f"{what} needs an index; this system was opened with "
                "index='none' (store-only mode)")

    def query(self, text: str, *, max_new: int = 32,
              temperature=None) -> QueryResult:
        """The paper's one-query race (sequential reference path)."""
        self._require_index("query()")
        r = self._seq.query(text, max_new=max_new, temperature=temperature)
        s = self._seq_stats
        s.queries += 1
        s.hits += int(r.hit)
        s.misses += int(not r.hit)
        s.llm_cancelled += int(r.cancelled)
        return r

    def query_batch(self, texts: Sequence[str], *,
                    max_new: Union[int, Sequence[int]] = 32,
                    temperature=None) -> List[QueryResult]:
        """One embed + one MIPS dispatch + one batched decode, hit slots
        cancelled mid-flight (the serving path)."""
        self._require_index("query_batch()")
        return self._batched.query_batch(texts, max_new=max_new,
                                         temperature=temperature)

    @contextlib.contextmanager
    def serve(self):
        """Staged-pipeline admission: inside the ``with`` block,
        ``submit()`` enqueues queries into the stage-decoupled serving
        loop; on exit the pipeline drains and stops."""
        self._require_index("serve()")
        self._batched.serve()
        try:
            yield self
        finally:
            self._batched.stop_serving()

    def submit(self, text: str, *, max_new: int = 32,
               temperature=None) -> Future:
        """Enqueue one query (starts the serving pipeline on first use);
        a hit resolves at search time, a miss at decode completion."""
        self._require_index("submit()")
        return self._batched.submit(text, max_new=max_new,
                                    temperature=temperature)

    # -- accounting -----------------------------------------------------------
    def stats(self) -> SystemStats:
        merged = RuntimeStats(**dataclasses.asdict(self._seq_stats))
        if self._batched is not None:
            b = self._batched.stats
            for f in dataclasses.fields(RuntimeStats):
                setattr(merged, f.name,
                        getattr(merged, f.name) + getattr(b, f.name))
        return SystemStats(
            runtime=merged, store_rows=self.store.count,
            store_bytes=self.store.storage_bytes(),
            index_tier=tier_of(self.index),
            index_rows=len(self.index) if self.index is not None else 0,
            has_engine=self.engine is not None,
            pipeline=(self._batched.pipeline_stats()
                      if self._batched is not None else None))
