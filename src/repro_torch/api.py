"""One front door: the ``StorInfer`` system facade of the PyTorch port
(port of the JAX package's ``api.py``).

    from repro_torch import StorInfer, SystemCfg
    from repro_torch.core.kb import build_kb

    kb = build_kb("squad", n_docs=25)
    with StorInfer.build(kb, SystemCfg(), "runs/demo", n_pairs=1500) as si:
        print(si.query_batch(["what is the height of aurora bridge?"]))

Everything runs on ``cfg.device`` ("cuda" unless the caller passes
"cpu"): the offline build's dedup index, the device-resident serving
index, a neural embedder and the fallback engine. Underneath, the duck
types are checked ``Protocol``s (``EmbedderProtocol``,
``IndexProtocol``) and components are resolved
from string registries (``EMBEDDERS``: ``"hash"``, ``"minilm"``;
``INDEXES``: ``"auto"``, ``"flat"``, ``"ivf"``, ``"sharded"``,
``"none"``). ``mesh=`` (a ``launch/mesh.Mesh``) lets ``"auto"`` pick the
sharded tier at paper scale (rows over the mesh's model axis), also on a
§3.1 write-back rebuild; ``"sharded"`` needs it.

Lifecycle:

    StorInfer.build(source, cfg, path, n_pairs=...)
                                     offline: resumable wave-batched
                                     generation into ``path`` (wraps
                                     ``PrecomputePipeline``; kill it and
                                     rerun — it continues from the manifest
                                     checkpoint), then ``open``s the store
    StorInfer.open(path, cfg)        online: store + index (a persisted
                                     IVF fit loads instead of refitting)
                                     (+ engine when ``cfg.engine`` is set,
                                     or ``engine=``)
    .query() / .query_batch()        sequential race / batched microbatch
    .serve() / .submit()             stage-decoupled serving pipeline
    .stats() / .close()              accounting, teardown

A store built by either package opens in the other unchanged (same
on-disk format), and a checkpointed build resumes in either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import Future
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np

from repro_torch.core.embedder import HashEmbedder, MiniLMEncoder
from repro_torch.core.generator import (GenCfg, QueryLM, SyntheticOracleLM,
                                        chunk_key)
from repro_torch.core.index import (FlatIndex, IncrementalIndex, IVFIndex,
                                    ShardedIndex, auto_index,
                                    cached_device_store, device_store_for,
                                    exact_fp32, sharded_index)
from repro_torch.core.precompute import (PrecomputeCfg, PrecomputePipeline,
                                         PrecomputeStats)
from repro_torch.core.runtime import (BatchedRuntime, BatchedRuntimeCfg,
                                      QueryResult, RuntimeCfg, RuntimeStats,
                                      StorInferRuntime)
from repro_torch.core.store import SHARD_ROWS, PrecomputedStore
from repro_torch.core.tokenizer import Tokenizer

__all__ = [
    "EmbedderProtocol", "IndexProtocol", "IndexCaps", "index_caps",
    "register_embedder", "register_index", "make_embedder", "make_index",
    "make_pipeline", "tier_of", "EngineCfg", "SystemCfg", "SystemStats",
    "StorInfer", "QueryResult", "RuntimeStats",
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


@dataclasses.dataclass(frozen=True)
class IndexCaps:
    """What an index can do beyond ``search``: persist its build product
    (``save``/``load``, IVF's k-means fit) and grow in place (``add``,
    the incremental dedup tier)."""
    save: bool
    load: bool
    add: bool


def index_caps(index) -> IndexCaps:
    return IndexCaps(save=callable(getattr(index, "save", None)),
                     load=callable(getattr(type(index), "load", None)),
                     add=callable(getattr(index, "add", None)))


_TIER_NAMES = {FlatIndex: "flat", IVFIndex: "ivf", ShardedIndex: "sharded",
               IncrementalIndex: "incremental"}


def tier_of(index) -> str:
    """Registry-name of an index instance (``"none"`` for store-only)."""
    if index is None:
        return "none"
    return _TIER_NAMES.get(type(index), type(index).__name__.lower())


# ---------------------------------------------------------------------------
# String registries
# ---------------------------------------------------------------------------

EMBEDDERS: Dict[str, Callable[..., Any]] = {}
INDEXES: Dict[str, Callable[..., Any]] = {}


def register_embedder(name: str, factory: Callable[..., Any]):
    """Register ``factory(tokenizer=None, device=..., **kw) ->
    EmbedderProtocol``; ``device`` places a neural embedder."""
    EMBEDDERS[name] = factory
    return factory


def register_index(name: str, factory: Callable[..., Any]):
    """Register ``factory(source, mesh=None, device=..., cache_dir=None,
    **kw) -> IndexProtocol`` where ``source`` is a store, an embeddings
    view, or a raw ``(n, dim)`` array."""
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


def make_index(spec: Union[str, IndexProtocol], source=None, *, mesh=None,
               cache_dir=None, **kw) -> Optional[IndexProtocol]:
    """Resolve a tier name (or validate an instance) to an index over
    ``source`` (on ``mesh`` when one is given). ``"none"`` returns None
    (store-only mode)."""
    if isinstance(spec, str):
        if spec == "none":
            return None
        try:
            factory = INDEXES[spec]
        except KeyError:
            raise KeyError(f"unknown index tier {spec!r}; registered: "
                           f"{sorted(INDEXES)}") from None
        idx = factory(source, mesh=mesh, cache_dir=cache_dir, **kw)
    else:
        idx = spec
    if not isinstance(idx, IndexProtocol):
        raise TypeError(f"{type(idx).__name__} does not satisfy "
                        "IndexProtocol (needs .search and __len__)")
    return idx


def _minilm_factory(tokenizer=None, device="cuda", **kw):
    if tokenizer is None:
        raise ValueError("the 'minilm' embedder needs tokenizer=")
    return MiniLMEncoder(tokenizer, device=device, **kw)


def _embs_of(source):
    return source.embeddings() if hasattr(source, "embeddings") else source


def _sharded_factory(source, mesh=None, cache_dir=None, device="cuda",
                     **kw):
    if mesh is None:
        raise ValueError("the 'sharded' index tier needs mesh=")
    return sharded_index(np.asarray(_embs_of(source), np.float32), mesh,
                         device=device, **kw)


def _flat_factory(source, mesh=None, cache_dir=None, use_kernel=False,
                  device="cuda"):
    # stores get the per-store DeviceStore cache, so §3.1 write-back
    # rebuilds of a pinned "flat" tier append deltas instead of
    # re-uploading the matrix (auto_index does the same for "auto")
    layout = "kernel" if use_kernel else "auto"
    if hasattr(source, "embeddings"):
        return FlatIndex(device=device_store_for(source, layout=layout,
                                                 device=device),
                         use_kernel=use_kernel)
    return FlatIndex(source, use_kernel=use_kernel, on=device)


def _ivf_factory(source, mesh=None, cache_dir=None, device="cuda", **kw):
    # reuses a flat residency the store already has; never creates one
    if not hasattr(source, "embeddings"):
        return IVFIndex(source, on=device, **kw)
    return IVFIndex(source.embeddings(), on=device,
                    device=cached_device_store(source, device), **kw)


register_embedder("hash", lambda tokenizer=None, device=None, **kw:
                  HashEmbedder(**kw))
register_embedder("minilm", _minilm_factory)
register_index("auto", auto_index)
register_index("flat", _flat_factory)
register_index("ivf", _ivf_factory)
register_index("sharded", _sharded_factory)


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
    on BOTH the sequential and batched paths; ``device`` places the
    build's dedup index, the serving index, a neural embedder and the
    engine.
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
    # -- staged-pipeline conveniences (override cfg.batched's knobs) ------
    decode_slots: Optional[int] = None     # persistent decode slot count
    queue_depth: Optional[int] = None      # per-stage bounded queue depth
    async_writeback: Optional[bool] = None  # §3.1 write-back off the
    #                                         critical path (background
    #                                         rebuild + atomic index swap)
    cache_index: bool = True           # persist/load the IVF fit in the
                                       # store root (index_ivf.npz)
    device: str = "cuda"
    gen: GenCfg = dataclasses.field(default_factory=GenCfg)
    precompute: PrecomputeCfg = dataclasses.field(
        default_factory=PrecomputeCfg)
    emb_dtype: str = "float16"         # store embedding dtype
    quantize: bool = False             # convenience: emb_dtype="int8"
    #                                    (symmetric per-row int8 shards +
    #                                    scales, served by the int8 MIPS
    #                                    kernel)
    shard_rows: int = SHARD_ROWS       # store shard size (rows)

    def __post_init__(self):
        if self.s_th_run is not None:
            self.runtime = dataclasses.replace(self.runtime,
                                               s_th_run=self.s_th_run)
            self.batched = dataclasses.replace(self.batched,
                                               s_th_run=self.s_th_run)
        pipeline_kw = {k: getattr(self, k)
                       for k in ("decode_slots", "queue_depth",
                                 "async_writeback")
                       if getattr(self, k) is not None}
        if pipeline_kw:
            self.batched = dataclasses.replace(self.batched, **pipeline_kw)
        if self.quantize:
            self.emb_dtype = "int8"
        elif self.emb_dtype == "int8":
            self.quantize = True


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


def make_pipeline(cfg: SystemCfg, lm: QueryLM,
                  tokenizer) -> PrecomputePipeline:
    """The offline half on its own (store-free benchmarking, custom build
    loops), on ``cfg.device``; ``StorInfer.build`` uses this
    internally."""
    emb = make_embedder(cfg.embedder, tokenizer=tokenizer,
                        **{"device": cfg.device, **cfg.embedder_kw})
    return PrecomputePipeline(lm, emb, tokenizer, cfg.gen, cfg.precompute,
                              device=cfg.device)


def _resolve_source(source, lm, tokenizer):
    """``source`` is a KB (chunks + oracle LM + tokenizer derived) or a
    raw chunk sequence (``lm=`` required)."""
    if hasattr(source, "docs"):
        texts = [d.text() for d in source.docs]
        chunks = [chunk_key(d.doc_id, d.text()) for d in source.docs]
        lm = lm if lm is not None else SyntheticOracleLM(source)
        tokenizer = tokenizer or Tokenizer.from_texts(texts)
    else:
        chunks = list(source)
        if lm is None:
            raise ValueError("building from raw chunks needs lm= "
                             "(a QueryLM); a KB source derives its own")
        tokenizer = tokenizer or Tokenizer.from_texts(chunks)
    return chunks, lm, tokenizer


def _tokenizer_from_store(store, sample: int = 512):
    """Vocab for an engine opened over a bare store: built from a sample
    of the stored pairs (the store IS the corpus at serve time)."""
    texts = []
    for row in range(min(store.count, sample)):
        q, r = store.get_pair(row)
        texts += [q, r]
    return Tokenizer.from_texts(texts or ["empty"])


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

    Construct via ``StorInfer.build`` (offline: generate into a store,
    then serve it), ``StorInfer.open`` (serve an existing store) or
    directly from ready components (protocol-checked)."""

    def __init__(self, store: PrecomputedStore, embedder, index=None, *,
                 engine=None, cfg: SystemCfg = None, mesh=None,
                 build_stats: Optional[PrecomputeStats] = None):
        self.store = store
        self.mesh = mesh
        self.embedder = make_embedder(embedder)   # validates the protocol
        self.index = make_index(index) if index is not None else None
        self.engine = engine
        self.cfg = cfg or SystemCfg()
        self.build_stats = build_stats
        self.index_seconds = 0.0    # wall-clock of the index build/load
        if str(self.cfg.device).startswith("cuda") or getattr(
                getattr(engine, "device", None), "type", None) == "cuda":
            exact_fp32()
        self._seq_stats = RuntimeStats()
        self._seq = self._batched = None
        if self.index is not None:
            self._seq = StorInferRuntime(self.index, store, self.embedder,
                                         engine, cfg=self.cfg.runtime)
            # §3.1 write-back rebuilds honor the DECLARED tier and its
            # kwargs; an instance-configured index has no recipe, so its
            # rebuilds fall back to auto_index
            cache_dir = str(store.root) if self.cfg.cache_index else None
            rebuild = None
            if isinstance(self.cfg.index, str):
                rebuild = lambda store, mesh: make_index(   # noqa: E731
                    self.cfg.index, store, mesh=mesh,
                    device=self.cfg.device, cache_dir=cache_dir,
                    **self.cfg.index_kw)
            self._batched = BatchedRuntime(
                self.index, store, self.embedder, engine,
                cfg=self.cfg.batched, mesh=mesh,
                auto_index_kw={"device": self.cfg.device,
                               "cache_dir": cache_dir}, rebuild=rebuild)

    # -- lifecycle ------------------------------------------------------------
    @classmethod
    def build(cls, source, cfg: SystemCfg = None, path=None, *,
              n_pairs: int, lm: QueryLM = None, tokenizer=None,
              seed: int = 0, resume: bool = True, on_wave=None, mesh=None,
              _kill_after_waves: Optional[int] = None) -> "StorInfer":
        """Offline build (resumable) on ``cfg.device``, then open the
        serving side.

        ``source`` is a KB or a sequence of knowledge-chunk strings.
        If ``path`` holds a checkpointed build, generation CONTINUES from
        it (``resume=False`` refuses); kill + rerun yields a store
        byte-identical to an uninterrupted run (see core/precompute.py).
        A crash mid-build releases the store handle without committing
        anything past the last checkpoint.
        """
        cfg = cfg or SystemCfg()
        if path is None:
            raise ValueError("build needs a store path")
        if str(cfg.device).startswith("cuda"):
            exact_fp32()
        chunks, lm, tokenizer = _resolve_source(source, lm, tokenizer)
        pipe = make_pipeline(cfg, lm, tokenizer)
        try:
            store = PrecomputedStore.open_(path)
        except FileNotFoundError:
            store = PrecomputedStore(path, dim=pipe.embedder.dim,
                                     emb_dtype=cfg.emb_dtype,
                                     shard_rows=cfg.shard_rows)
        try:
            _, _, _, stats = pipe.run(
                chunks, n_pairs, store=store, seed=seed, resume=resume,
                on_wave=on_wave, _kill_after_waves=_kill_after_waves)
        except BaseException:
            store.abort()      # crash semantics: keep the last checkpoint
            raise
        return cls._from_store(store, cfg, tokenizer=tokenizer, mesh=mesh,
                               embedder=pipe.embedder, build_stats=stats)

    @classmethod
    def open(cls, path, cfg: SystemCfg = None, *, tokenizer=None,
             engine=None, mesh=None) -> "StorInfer":
        """Open an existing store for serving: memory-mapped shards, the
        index on ``cfg.device`` (with ``cfg.cache_index`` a persisted IVF
        fit in the store root loads instead of refitting; on ``mesh``,
        ``"auto"`` picks the sharded tier at paper scale), and the engine
        (``engine=``, or built from ``cfg.engine`` when set)."""
        store = PrecomputedStore.open_(path)
        return cls._from_store(store, cfg, tokenizer=tokenizer,
                               engine=engine, mesh=mesh)

    @classmethod
    def _from_store(cls, store, cfg=None, *, tokenizer=None, engine=None,
                    embedder=None, build_stats=None,
                    mesh=None) -> "StorInfer":
        cfg = cfg or SystemCfg()
        if embedder is None:
            embedder = make_embedder(cfg.embedder, tokenizer=tokenizer,
                                     **{"device": cfg.device,
                                        **cfg.embedder_kw})
        t0 = time.perf_counter()
        index = make_index(cfg.index, store, mesh=mesh, device=cfg.device,
                           cache_dir=(str(store.root) if cfg.cache_index
                                      else None), **cfg.index_kw)
        index_s = time.perf_counter() - t0
        if engine is None and cfg.engine is not None:
            tok = tokenizer or _tokenizer_from_store(store)
            engine = _build_engine(cfg.engine, tok, cfg.device)
        si = cls(store, embedder, index, engine=engine, cfg=cfg, mesh=mesh,
                 build_stats=build_stats)
        si.index_seconds = index_s
        return si

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
