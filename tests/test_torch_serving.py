"""The port's serving slice against the JAX reference, on the CPU: a store
built by the reference ``StorInfer.build`` (hash embedder,
``SyntheticOracleLM``) is opened by both packages and served the same
stream — same hit/miss split, same hit rows, same greedy miss text (the
port's engine gets the reference engine's weights through
``params_from_jax``) — plus the port's import isolation: nothing of JAX
or of the ``repro`` package may load when the port serves, and
``chip_smoke.py`` refuses to run without a card; and the facade's
configuration and capability helpers (``SystemCfg``'s staged-pipeline
overrides, ``IndexCaps``/``index_caps``) against the reference's."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.api import EngineCfg as JEngineCfg
from repro.api import StorInfer as JStorInfer
from repro.api import SystemCfg as JSystemCfg
from repro.core.kb import build_kb, sample_user_queries
from repro.api import index_caps as j_index_caps
from repro.core.runtime import BatchedRuntimeCfg as JBatchedRuntimeCfg
from repro_torch.api import (EngineCfg, IndexCaps, StorInfer, SystemCfg,
                             index_caps, tier_of)
from repro_torch.core.runtime import BatchedRuntimeCfg
from repro_torch.configs import get_config, reduced
from repro_torch.core.tokenizer import Tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
MAX_LEN, CHUNK, MAX_NEW = 64, 4, 8


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    kb = build_kb("squad", n_docs=8)
    path = tmp_path_factory.mktemp("serving") / "store"
    JStorInfer.build(kb, JSystemCfg(), path, n_pairs=120).close()
    return kb, path


def _stream(kb, path):
    from repro.core.store import PrecomputedStore
    st = PrecomputedStore.open_(path)
    stored = [st.get_pair(r)[0] for r in (0, 7, 31)]
    st.close()
    users = [q for q, _ in sample_user_queries(kb, 10, seed=3)]
    return stored + users + ["zebra xylophone never stored anywhere"]


def _port_engine(jax_engine):
    cfg = dataclasses.replace(reduced(get_config(jax_engine.cfg.name
                                                 .removesuffix("-smoke"))),
                              vocab_size=jax_engine.cfg.vocab_size,
                              n_layers=jax_engine.cfg.n_layers)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jax_engine.params),
                             device="cpu")
    return Engine(cfg, params, Tokenizer(list(jax_engine.tok.words)),
                  max_len=jax_engine.max_len, chunk=jax_engine.chunk)


def _summary(results):
    return [(r.hit, r.source, r.matched_query, r.response if r.hit else None)
            for r in results]


def test_search_only_same_split_and_rows(built):
    kb, path = built
    texts = _stream(kb, path)
    with JStorInfer.open(path, JSystemCfg(index="flat")) as ref, \
            StorInfer.open(path, SystemCfg(index="flat", device="cpu")) as si:
        rj, rt = ref.query_batch(texts), si.query_batch(texts)
        assert _summary(rt) == _summary(rj)
        np.testing.assert_allclose([r.score for r in rt],
                                   [r.score for r in rj], atol=1e-5)
        assert all(r.hit for r in rt[:3]) and not rt[-1].hit
        assert tier_of(si.index) == "flat"
        one = si.query(texts[0])
        assert one.hit and one.response == rt[0].response
        s = si.stats()
        assert s.runtime.queries == len(texts) + 1
        assert s.store_rows == s.index_rows == 120 and not s.has_engine


def test_engine_same_greedy_miss_text(built):
    kb, path = built
    texts = _stream(kb, path)
    jcfg = JSystemCfg(index="flat", engine=JEngineCfg(
        smoke=True, max_len=MAX_LEN, chunk=CHUNK))
    with JStorInfer.open(path, jcfg) as ref:
        engine = _port_engine(ref.engine)
        rj = ref.query_batch(texts, max_new=MAX_NEW)
        seq_j = ref.query(texts[-1], max_new=MAX_NEW)
        with StorInfer.open(path, SystemCfg(index="flat", device="cpu"),
                            engine=engine) as si:
            rt = si.query_batch(texts, max_new=MAX_NEW)
            seq_t = si.query(texts[-1], max_new=MAX_NEW)
            assert _summary(rt) == _summary(rj)
            misses = [(a.response, b.response) for a, b in zip(rt, rj)
                      if not a.hit]
            assert misses and all(a == b for a, b in misses)
            assert all(r.tokens >= 1 for r in rt if not r.hit)
            assert seq_t.response == seq_j.response and not seq_t.hit
            # the same stream through the staged pipeline
            with si.serve():
                futs = [si.submit(t, max_new=MAX_NEW) for t in texts]
                rs = [f.result(timeout=300) for f in futs]
            assert [r.hit for r in rs] == [r.hit for r in rj]
            assert [r.response for r in rs if r.hit] == \
                [r.response for r in rj if r.hit]
            assert si.stats().pipeline["search_batches"] >= 1


_SYSTEM_CFGS = [
    {},
    {"queue_depth": 8},
    {"async_writeback": False},
    {"queue_depth": 8, "async_writeback": True},
    {"decode_slots": 2, "queue_depth": 3, "async_writeback": False},
    {"s_th_run": 0.8, "decode_slots": 6},
    {"batched": "custom", "queue_depth": 5},
    {"batched": "custom"},
]


@pytest.mark.parametrize("kw", _SYSTEM_CFGS,
                         ids=[",".join(k) or "default" for k in _SYSTEM_CFGS])
def test_system_cfg_maps_to_the_reference_batched_cfg(kw):
    """``decode_slots``, ``queue_depth`` and ``async_writeback`` override
    ``cfg.batched`` (and ``s_th_run`` both runtimes) as in the reference:
    both packages give the same ``BatchedRuntimeCfg`` field for field."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("batched") == "custom":
        custom = dict(max_batch=7, add_misses=True, rebuild_every=9,
                      queue_depth=11, async_writeback=False)
        jkw["batched"] = JBatchedRuntimeCfg(**custom)
        tkw["batched"] = BatchedRuntimeCfg(**custom)
    j, t = JSystemCfg(**jkw), SystemCfg(**tkw)
    assert dataclasses.asdict(t.batched) == dataclasses.asdict(j.batched)
    assert dataclasses.asdict(t.runtime) == dataclasses.asdict(j.runtime)
    for k in ("queue_depth", "async_writeback", "decode_slots"):
        if k in kw:
            assert getattr(t.batched, k) == kw[k]


def test_index_caps_are_the_reference_caps():
    """IVF saves and loads, flat does neither, the incremental dedup
    index adds (the reference's ``tests/test_api.py`` case), and each
    flag equals the reference's on the reference's own tiers."""
    import repro_torch
    from repro.core.index import FlatIndex as JFlat
    from repro.core.index import IncrementalIndex as JIncremental
    from repro.core.index import IVFIndex as JIVF
    from repro_torch.core.index import FlatIndex, IncrementalIndex, IVFIndex
    x = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    flat = FlatIndex(x, on="cpu")
    ivf = IVFIndex(x, n_lists=4, nprobe=2, on="cpu")
    assert repro_torch.IndexCaps is IndexCaps
    assert repro_torch.index_caps is index_caps
    assert index_caps(ivf) == IndexCaps(save=True, load=True, add=False)
    assert index_caps(flat) == IndexCaps(save=False, load=False, add=False)
    assert index_caps(IncrementalIndex(16, device="cpu")).add
    assert tier_of(IncrementalIndex(16, device="cpu")) == "incremental"
    for t, j in ((flat, JFlat(x)), (ivf, JIVF(x, n_lists=4, nprobe=2)),
                 (IncrementalIndex(16, device="cpu"), JIncremental(16))):
        assert dataclasses.astuple(index_caps(t)) == \
            dataclasses.astuple(j_index_caps(j))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {f.name for f in examples} == {
        "quickstart_torch.py", "storinfer_serve_torch.py",
        "train_small_torch.py"}
    files += examples
    assert len(files) > 20
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files
             if "repro_torch" in f.parts}
    assert {"core/metrics.py", "core/latency.py", "core/embedder.py",
            "configs/storinfer_paper.py", "configs/llama3_2_3b.py",
            "configs/starcoder2_7b.py", "configs/qwen2_5_32b.py",
            "configs/deepseek_v2_lite_16b.py", "configs/grok_1_314b.py",
            "configs/mamba2_130m.py", "configs/zamba2_1_2b.py",
            "models/mla.py", "models/moe.py", "models/ssm.py",
            "configs/whisper_base.py", "configs/qwen2_vl_72b.py",
            "models/blockwise.py", "training/__init__.py",
            "training/optimizer.py", "training/train.py",
            "training/compression.py", "training/data.py",
            "training/checkpoint.py", "launch/train.py",
            "distributed/train_parallel.py", "launch/specs.py",
            "distributed/multihost.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


_ISOLATION = r"""
import sys, tempfile
from pathlib import Path
from repro_torch.api import EngineCfg, StorInfer, SystemCfg
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.kb import build_kb
from repro_torch.launch.serve import kb_pairs, write_kb_store
kb = build_kb("squad", n_docs=4)
path = Path(tempfile.mkdtemp()) / "store"
write_kb_store(path, kb, HashEmbedder(), 400, seed=1).close()
cfg = SystemCfg(index="flat", device="cpu",
                engine=EngineCfg(max_len=64, chunk=4))
with StorInfer.open(path, cfg) as si:
    q0 = kb_pairs(kb)[0][0]
    rs = si.query_batch([q0, "zebra xylophone"], max_new=4)
    assert rs[0].hit and not rs[1].hit, rs
    with si.serve():
        assert si.submit("zebra two", max_new=4).result(timeout=120).tokens
for arch in ("deepseek-v2-lite-16b", "grok-1-314b", "mamba2-130m",
             "zamba2-1.2b"):
    cfg = SystemCfg(index="flat", device="cpu",
                    engine=EngineCfg(arch=arch, max_len=64, chunk=4))
    with StorInfer.open(path, cfg) as si:
        assert si.engine.cfg.family in ("moe", "ssm", "hybrid"), arch
        rs = si.query_batch(["zebra xylophone", "zebra three"], max_new=4)
        assert all(not r.hit and r.tokens for r in rs), (arch, rs)
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
for arch in ("whisper-base", "qwen2-vl-72b"):
    mc = reduced(get_config(arch))
    params = M.init_model(mc, torch.Generator().manual_seed(0),
                          dtype="float32", device="cpu")
    kw = {"frames": torch.randn(1, mc.encoder_seq, mc.d_model)} \
        if mc.is_encoder_decoder else \
        {"mrope_positions": torch.zeros(3, 1, 5, dtype=torch.long)}
    lg, cache = M.prefill(mc, params,
                          dict(kw, tokens=torch.ones(1, 5, dtype=torch.long)),
                          max_len=8)
    M.decode_step(mc, params, torch.ones(1, 1, dtype=torch.long), cache, 5)
ck = str(Path(tempfile.mkdtemp()) / "ck")
launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                   "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt",
                   ck, "--ckpt-every", "1", "--compress"])
assert CK.Checkpointer(ck).latest_step() == 2
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh
from repro_torch.training import optimizer as O
from repro_torch.training import train as T
mc = reduced(get_config("qwen3-1.7b"))
mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
params = M.init_model(mc, torch.Generator().manual_seed(0),
                      dtype="float32", device="cpu")
params = Sh.place(params, Sh.param_shardings(params, mesh, mc))
run = SP.make_runcfg(mc, ShapeConfig("t", 16, 4, "train"), mesh)
b = {"tokens": torch.ones(4, 16, dtype=torch.long),
     "labels": torch.ones(4, 16, dtype=torch.long)}
T.make_train_step(mc, run)(params, O.init(params), b)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ISOLATED")
"""


def test_serving_with_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


def test_launcher_serves_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n-pairs", "500", "--n-queries", "6", "--store",
         str(tmp_path / "store"), "--index", "flat"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "loaded store: 500 pairs on cpu" in out.stdout
    assert "staged pipeline:" in out.stdout


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
