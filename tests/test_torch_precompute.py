"""The port's offline precompute (``core/generator.py``, ``core/index.py:
IncrementalIndex``, ``core/precompute.py``, ``serving/lm.py``,
``StorInfer.build``) against the JAX reference on the CPU, at the
reference tests' size (squad, 6 docs, hash embedder, SyntheticOracleLM).

Builds from both packages are compared byte for byte: the same queries,
responses, embeddings, counts and final temperatures, and the same store
files (the manifest's build clock excepted). The port's dedup products are
torch f32 products and the reference's numpy ones, so their similarity
scores may differ in the last bits of f32 (summation order); no decision
sits that close to the 0.99 threshold on these inputs, and a flip would
fail the comparison, not be tolerated. The IVF mode's k-means seeding is
the port's own (``jax.random`` cannot be reproduced), so across packages
the stores are compared while the dedup index stays flat.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import StorInfer as JStorInfer
from repro.api import SystemCfg as JSystemCfg
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.embedder import HashEmbedder as JHashEmbedder
from repro.core.generator import GenCfg as JGenCfg
from repro.core.generator import SyntheticOracleLM as JOracle
from repro.core.generator import chunk_key as jchunk_key
from repro.core.index import IncrementalIndex as JIncrementalIndex
from repro.core.kb import build_kb as jbuild_kb
from repro.core.precompute import BuildKilled as JBuildKilled
from repro.core.precompute import PrecomputeCfg as JPrecomputeCfg
from repro.core.precompute import PrecomputePipeline as JPipeline
from repro.core.store import PrecomputedStore as JStore
from repro.core.tokenizer import Tokenizer as JTokenizer
from repro.models import model as JM
from repro.serving import lm as JLM
from repro.serving.engine import Engine as JEngine
from repro_torch.api import (EngineCfg, StorInfer, SystemCfg, _build_engine,
                             make_pipeline)
from repro_torch.configs import get_config, reduced
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.generator import (GenCfg, QueryGenerator,
                                        SyntheticOracleLM, chunk_key)
from repro_torch.core.index import IncrementalIndex
from repro_torch.core.kb import build_kb
from repro_torch.core.precompute import (STATE_KEY, BuildKilled,
                                         PrecomputeCfg, PrecomputePipeline)
from repro_torch.core.store import PrecomputedStore
from repro_torch.core.tokenizer import Tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import lm as TLM
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
N_DOCS = 6
# dedup similarities: the port's torch f32 products against the
# reference's numpy ones, and a flat max_sim against brute force, differ
# by summation order only: a few ulps of f32 at |s| <= 1
TOL_SIM = 1e-6


@pytest.fixture(scope="module")
def env():
    """Each package's own KB, hash embedder, tokenizer and chunks."""
    kb, jkb = build_kb("squad", n_docs=N_DOCS), jbuild_kb("squad",
                                                           n_docs=N_DOCS)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs])
    jtok = JTokenizer.from_texts([d.text() for d in jkb.docs])
    chunks = [chunk_key(d.doc_id, d.text()) for d in kb.docs]
    jchunks = [jchunk_key(d.doc_id, d.text()) for d in jkb.docs]
    assert chunks == jchunks
    return dict(kb=kb, tok=tok, chunks=chunks, jkb=jkb, jtok=jtok,
                jchunks=jchunks)


def port_pipe(env, wave, gen=None, **cfg_kw):
    return PrecomputePipeline(SyntheticOracleLM(env["kb"]), HashEmbedder(),
                              env["tok"], gen or GenCfg(dedup=True),
                              PrecomputeCfg(wave=wave, **cfg_kw),
                              device="cpu")


def ref_pipe(env, wave, **cfg_kw):
    return JPipeline(JOracle(env["jkb"]), JHashEmbedder(), env["jtok"],
                     JGenCfg(dedup=True), JPrecomputeCfg(wave=wave, **cfg_kw))


def _manifest(path):
    man = json.loads((path / "manifest.json").read_text())
    man.get("extra", {}).get(STATE_KEY, {}).pop("elapsed", None)
    return man


def assert_same_store(a, b):
    """Every file of two store directories byte for byte; the manifest
    with the build clock (``elapsed``) taken out."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for f in names:
        if f == "manifest.json":
            assert _manifest(a) == _manifest(b)
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _upper_sims(e):
    """Each accepted row's max similarity to an EARLIER accepted row."""
    g = e @ e.T
    return np.asarray([g[i, :i].max() if i else -np.inf
                       for i in range(len(e))])


# ---------------------------------------------------------------------------
# Builds against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emb_dtype", ["float16", "int8"])
@pytest.mark.parametrize("wave", [1, 32])
def test_pipeline_build_matches_reference(env, tmp_path, wave, emb_dtype):
    sj = JStore(tmp_path / "ref", dim=384, emb_dtype=emb_dtype,
                shard_rows=64)
    jq, jr, je, js = ref_pipe(env, wave).run(env["jchunks"], 150, store=sj,
                                             seed=3)
    sj.close()
    st = PrecomputedStore(tmp_path / "port", dim=384, emb_dtype=emb_dtype,
                          shard_rows=64)
    q, r, e, s = port_pipe(env, wave).run(env["chunks"], 150, store=st,
                                          seed=3)
    st.close()
    assert (q, r) == (jq, jr)
    np.testing.assert_array_equal(e, je)
    assert (s.generated, s.discarded, s.waves) == \
        (js.generated, js.discarded, js.waves)
    assert s.discarded > 0, "dedup never triggered (test too easy)"
    assert s.temp_final == js.temp_final
    assert s.index_mode == js.index_mode == "flat"
    assert_same_store(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("emb_dtype", ["float16", "int8"])
@pytest.mark.parametrize("wave", [1, 32])
def test_storinfer_build_matches_reference(env, tmp_path, wave, emb_dtype):
    kw = dict(index="flat", emb_dtype=emb_dtype, shard_rows=64)
    with JStorInfer.build(env["jkb"], JSystemCfg(
            precompute=JPrecomputeCfg(wave=wave), **kw), tmp_path / "ref",
            n_pairs=100, seed=1) as sj:
        jstats = sj.build_stats
    cfg = SystemCfg(device="cpu", precompute=PrecomputeCfg(wave=wave), **kw)
    assert cfg.quantize == (emb_dtype == "int8")
    with StorInfer.build(env["kb"], cfg, tmp_path / "port", n_pairs=100,
                         seed=1) as si:
        assert si.store.count == 100 and len(si.index) == 100
        assert si.build_stats.discarded == jstats.discarded
        assert si.index_seconds > 0
        # the opened store serves its own rows
        got = si.query_batch([si.store.get_pair(7)[0]], max_new=4)[0]
        assert got.hit and got.response == si.store.get_pair(7)[1]
    assert_same_store(tmp_path / "ref", tmp_path / "port")


def test_wave1_matches_sequential_generator(env):
    """At wave=1 the pipeline consumes the RNG in the sequential
    generator's order and makes its accept/discard/temperature decisions
    (store-free: both dedup raw f32)."""
    gen = QueryGenerator(SyntheticOracleLM(env["kb"]), HashEmbedder(),
                         env["tok"], GenCfg(dedup=True))
    sq, sr, se, ss = gen.generate(env["chunks"], 120, seed=3)
    bq, br, be, bs = port_pipe(env, wave=1).run(env["chunks"], 120, seed=3)
    assert (sq, sr) == (bq, br)
    np.testing.assert_array_equal(se, be)
    assert (ss.generated, ss.discarded) == (bs.generated, bs.discarded)
    assert ss.temp_final == bs.temp_final


def test_wave_mode_keeps_no_pair_above_the_threshold(env):
    q, r, e, stats = port_pipe(env, wave=16).run(env["chunks"], 150, seed=0)
    assert len(q) == len(r) == len(e) == 150
    assert _upper_sims(e).max() < 0.99, "accepted pair above S_th_Gen"
    assert stats.discarded > 0
    assert 0.7 < stats.temp_final <= 1.0 + 1e-9


# ---------------------------------------------------------------------------
# Kill / resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flat_max_rows", [10_000, 64])
def test_kill_and_resume_is_byte_identical(env, tmp_path, flat_max_rows):
    """Across the IVF transition too (flat_max_rows=64: refits at 64 and
    128 rows, the resumed build rebuilds its index shard by shard)."""
    A, B = tmp_path / "uninterrupted", tmp_path / "resumed"
    kw = dict(wave=8, checkpoint_every=3, flat_max_rows=flat_max_rows)
    sa = PrecomputedStore(A, dim=384, shard_rows=64)
    stats_a = port_pipe(env, **kw).run(env["chunks"], 160, store=sa,
                                       seed=7)[3]
    sa.close()
    sb = PrecomputedStore(B, dim=384, shard_rows=64)
    with pytest.raises(BuildKilled):
        port_pipe(env, **kw).run(env["chunks"], 160, store=sb, seed=7,
                                 _kill_after_waves=11)
    sb._text_f.close()
    sb2 = PrecomputedStore.open_(B)
    stats = port_pipe(env, **kw).run(env["chunks"], 160, store=sb2,
                                     seed=7)[3]
    sb2.close()
    assert 0 < stats.resumed_rows < 160
    assert stats.resumed_rows + stats.generated == 160
    want = "flat" if flat_max_rows > 160 else "ivf"
    assert stats_a.index_mode == stats.index_mode == want
    if want == "ivf":
        assert stats.resumed_rows > 64 and stats_a.refits == 2
    assert_same_store(A, B)


@pytest.mark.parametrize("killer", ["reference", "port"])
def test_resume_across_packages_is_byte_identical(env, tmp_path, killer):
    """A build killed by one package and resumed by the other equals the
    reference's uninterrupted build, byte for byte (flat dedup index)."""
    A, B = tmp_path / "uninterrupted", tmp_path / "resumed"
    kw = dict(wave=8, checkpoint_every=3)
    sa = JStore(A, dim=384, shard_rows=64)
    ref_pipe(env, **kw).run(env["jchunks"], 160, store=sa, seed=7)
    sa.close()
    if killer == "reference":
        first, second = (lambda s: ref_pipe(env, **kw).run(
            env["jchunks"], 160, store=s, seed=7, _kill_after_waves=7),
            JBuildKilled), lambda s: port_pipe(env, **kw).run(
                env["chunks"], 160, store=s, seed=7)
        sb, reopen = JStore(B, dim=384, shard_rows=64), PrecomputedStore
    else:
        first, second = (lambda s: port_pipe(env, **kw).run(
            env["chunks"], 160, store=s, seed=7, _kill_after_waves=7),
            BuildKilled), lambda s: ref_pipe(env, **kw).run(
                env["jchunks"], 160, store=s, seed=7)
        sb, reopen = PrecomputedStore(B, dim=384, shard_rows=64), JStore
    with pytest.raises(first[1]):
        first[0](sb)
    sb._text_f.close()
    sb2 = reopen.open_(B)
    stats = second(sb2)[3]
    sb2.close()
    assert 0 < stats.resumed_rows < 160
    assert_same_store(A, B)


def test_resume_refuses_different_chunk_contents(env, tmp_path):
    s = PrecomputedStore(tmp_path / "s", dim=384, shard_rows=32)
    port_pipe(env, wave=4, checkpoint_every=2).run(env["chunks"], 40,
                                                   store=s, seed=0)
    kb2 = build_kb("squad", seed=99, n_docs=N_DOCS)
    chunks2 = [chunk_key(d.doc_id, d.text()) for d in kb2.docs]
    with pytest.raises(ValueError, match="DIFFERENT chunk contents"):
        PrecomputePipeline(SyntheticOracleLM(kb2), HashEmbedder(),
                           env["tok"], GenCfg(),
                           PrecomputeCfg(wave=4, checkpoint_every=2),
                           device="cpu").run(chunks2, 80, store=s, seed=0)
    s.close()


def test_resume_refuses_different_config(env, tmp_path):
    s = PrecomputedStore(tmp_path / "s", dim=384, shard_rows=32)
    port_pipe(env, wave=4, checkpoint_every=2).run(env["chunks"], 40,
                                                   store=s, seed=0)

    class OtherEmbedder(HashEmbedder):
        pass

    with pytest.raises(ValueError, match="mismatched settings"):
        PrecomputePipeline(SyntheticOracleLM(env["kb"]), OtherEmbedder(),
                           env["tok"], GenCfg(),
                           PrecomputeCfg(wave=4, checkpoint_every=2),
                           device="cpu").run(env["chunks"], 80, store=s,
                                             seed=0)
    with pytest.raises(ValueError, match="mismatched settings"):
        port_pipe(env, 4, gen=GenCfg(s_th_gen=0.95),
                  checkpoint_every=2).run(env["chunks"], 80, store=s,
                                          seed=0)
    with pytest.raises(ValueError, match="same wave size"):
        port_pipe(env, 8, checkpoint_every=2).run(env["chunks"], 80,
                                                  store=s, seed=0)
    s.close()


def test_resume_refuses_foreign_or_modified_store(env, tmp_path):
    emb = HashEmbedder()
    s = PrecomputedStore(tmp_path / "s", dim=384)
    s.add_batch(emb.encode(["a?"]), ["a?"], ["a."])
    s.flush()
    with pytest.raises(ValueError, match="no .* checkpoint"):
        port_pipe(env, wave=4).run(env["chunks"], 10, store=s, seed=0)
    s.close()
    s2 = PrecomputedStore(tmp_path / "s2", dim=384, shard_rows=32)
    port_pipe(env, wave=4, checkpoint_every=2).run(env["chunks"], 40,
                                                   store=s2, seed=0)
    s2.add_batch(emb.encode(["rogue"]), ["rogue"], ["row"])
    s2.flush()
    with pytest.raises(ValueError, match="modified outside"):
        port_pipe(env, wave=4, checkpoint_every=2).run(env["chunks"], 80,
                                                       store=s2, seed=0)
    s2.close()


def test_build_resume_refused_and_crash_keeps_checkpoint(env, tmp_path):
    """``StorInfer.build``: a killed build leaves its last checkpoint,
    ``resume=False`` refuses it, and a rerun completes it."""
    cfg = SystemCfg(device="cpu", index="none", shard_rows=32,
                    precompute=PrecomputeCfg(wave=4, checkpoint_every=2))
    with pytest.raises(BuildKilled):
        StorInfer.build(env["kb"], cfg, tmp_path / "s", n_pairs=60,
                        _kill_after_waves=5)
    man = json.loads((tmp_path / "s" / "manifest.json").read_text())
    assert man["count"] == man["extra"][STATE_KEY]["generated"] > 0
    with pytest.raises(ValueError, match="no .* checkpoint|store already"):
        StorInfer.build(env["kb"], cfg, tmp_path / "s", n_pairs=60,
                        resume=False)
    with StorInfer.build(env["kb"], cfg, tmp_path / "s", n_pairs=60) as si:
        assert si.store.count == 60 and si.index is None
        assert si.build_stats.resumed_rows == man["count"]


# ---------------------------------------------------------------------------
# IncrementalIndex
# ---------------------------------------------------------------------------


def _unit_rows(n, d, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_incremental_flat_matches_bruteforce_and_reference():
    x = _unit_rows(500, 64)
    idx = IncrementalIndex(64, flat_max_rows=10_000, device="cpu")
    ref = JIncrementalIndex(64, flat_max_rows=10_000)
    assert len(idx.max_sim(x[:2])) == 2 and idx.max_sim(x[:2])[0] == -np.inf
    for lo in range(0, 500, 37):          # ragged add batches
        idx.add(x[lo:lo + 37])
        ref.add(x[lo:lo + 37])
    assert idx.mode == "flat" and len(idx) == 500 and idx.nprobe == 1
    q = np.concatenate([_unit_rows(8, 64, seed=1), x[::97]])
    got = idx.max_sim(q)
    assert got.dtype == np.float32 and got.shape == (len(q),)
    np.testing.assert_allclose(got, (q @ x.T).max(axis=1), atol=TOL_SIM,
                               rtol=0)
    np.testing.assert_allclose(got, ref.max_sim(q), atol=TOL_SIM, rtol=0)


def test_incremental_ivf_transition_finds_duplicates():
    x = _unit_rows(600, 64)
    idx = IncrementalIndex(64, flat_max_rows=128, device="cpu")
    idx.add(x)
    assert idx.mode == "ivf"
    assert idx.refits == 3 and len(idx.refit_seconds) == 3   # 128, 256, 512
    assert idx.nprobe == 4 and idx.n_lists == 23
    # an exact duplicate of EVERY stored row probes the list that holds
    # its twin (one metric for assignment and probing)
    np.testing.assert_allclose(idx.max_sim(x), np.sum(x * x, axis=1),
                               atol=TOL_SIM, rtol=0)
    a = idx.assignment()
    assert a.shape == (600,) and 0 <= a.min() and a.max() < 23


def test_incremental_state_independent_of_add_batching():
    """Deterministic split-at-threshold refits and fixed-shape assignment
    blocks: the state depends only on the row sequence — what the resume
    path's shard-at-a-time rebuild relies on."""
    x = _unit_rows(2500, 32)
    a = IncrementalIndex(32, flat_max_rows=100, device="cpu")
    a.add(x)                               # one giant add
    b = IncrementalIndex(32, flat_max_rows=100, device="cpu")
    for lo in range(0, 2500, 13):          # many ragged adds
        b.add(x[lo:lo + 13])
    c = IncrementalIndex(32, flat_max_rows=100, device="cpu")
    for lo in range(0, 2500, 1100):        # adds past an assignment block
        c.add(x[lo:lo + 1100])
    for o in (b, c):
        assert o.refits == a.refits == 5
        assert torch.equal(a.centroids, o.centroids)
        np.testing.assert_array_equal(a.assignment(), o.assignment())
        q = _unit_rows(6, 32, seed=2)
        np.testing.assert_array_equal(a.max_sim(q), o.max_sim(q))


def test_incremental_n_lists_clamped_to_rows():
    """A refit over fewer rows than ``ivf_params`` asks lists for clamps
    the list count to the rows (k-means seeds distinct rows)."""
    x = _unit_rows(11, 16)
    idx = IncrementalIndex(16, flat_max_rows=8, device="cpu")
    idx.add(x)
    assert idx.mode == "ivf" and idx.n_lists == 8 and idx.nprobe == 4
    assert sorted(set(idx.assignment()[:8].tolist())) == list(range(8))
    np.testing.assert_allclose(idx.max_sim(x), np.sum(x * x, axis=1),
                               atol=TOL_SIM, rtol=0)


def test_incremental_background_refit_drains():
    x = _unit_rows(300, 16)
    idx = IncrementalIndex(16, flat_max_rows=64, background=True,
                           device="cpu")
    for lo in range(0, 300, 50):
        idx.add(x[lo:lo + 50])
    idx.drain()
    assert idx.mode == "ivf" and idx.refits >= 1 and len(idx) == 300
    assert float(idx.max_sim(x[::37]).min()) > 0.999


# ---------------------------------------------------------------------------
# TorchLM against TinyJaxLM, and an LLM-driven build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lms(env):
    """TinyJaxLM and TorchLM over the smoke arch (2 layers) with the same
    weights, at the LM engine's max_len 512 and at the serving engine's
    160 (the squad prompts overflow 160)."""
    cfg = dataclasses.replace(jreduced(jget_config("qwen3-1.7b")),
                              vocab_size=env["jtok"].vocab_size, n_layers=2)
    params = JM.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               vocab_size=env["tok"].vocab_size, n_layers=2)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    out = {}
    for max_len in (512, 160):
        jeng = JEngine(cfg, params, env["jtok"],
                       JM.RunCfg(attn_impl="naive", remat=False),
                       max_len=max_len, chunk=8)
        teng = Engine(tcfg, tparams, env["tok"], max_len=max_len, chunk=8)
        out[max_len] = (JLM.TinyJaxLM(jeng), TLM.TorchLM(teng))
    return out


def test_torch_lm_prompts_are_the_reference_prompts(env, lms):
    assert TLM.PROMPT == JLM.PROMPT
    masked = [f"earlier question {i}?" for i in range(11)]
    chunk = env["chunks"][2]
    want = JLM.PROMPT.format(masked="; ".join(masked[:8]),
                             chunk=chunk.split("\x00", 1)[-1])
    assert TLM.TorchLM.query_prompt(chunk, masked) == want
    jlm, tlm = lms[512]
    prompts = []
    jlm.engine.generate = tlm.engine.generate = \
        lambda p, **kw: prompts.append((p, kw)) or "q"
    try:
        for lm in (jlm, tlm):
            lm.generate_query(chunk, masked, 0.8, None)
            lm.generate_query(chunk, masked[:2], 0.9, None)
            lm.answer("what is it?", chunk)
    finally:
        del jlm.engine.generate, tlm.engine.generate
    assert prompts[:3] == prompts[3:]
    assert [kw["seed"] for _, kw in prompts[:2]] == [1, 2]
    assert prompts[2][1]["temperature"] is None


@pytest.mark.parametrize("max_len", [512, 160])
def test_torch_lm_answer_matches_reference_token_for_token(env, lms,
                                                           max_len):
    """Greedy ``answer`` text equal to ``TinyJaxLM``'s; at max_len 160 the
    prompt is cut to 159 tokens and every decode step writes the cache's
    last slot (the reference's clamped update)."""
    jlm, tlm = lms[max_len]
    for i, q in ((0, "what is the height of it?"), (3, "who founded it?")):
        chunk = env["chunks"][i]
        n = len(env["tok"].encode(TLM.TorchLM.answer_prompt(q, chunk),
                                  bos=True))
        assert (n > max_len) == (max_len == 160)
        assert tlm.answer(q, chunk) == jlm.answer(q, chunk)


def test_torch_lm_generates_queries_and_builds(env, tmp_path):
    """An LLM-driven ``StorInfer.build`` on the smoke arch on the CPU: the
    generator's prompts through the engine, sampled queries, greedy
    answers, the dedup invariant on the stored rows."""
    engine = _build_engine(EngineCfg(max_len=512, chunk=8), env["tok"],
                           "cpu")
    lm = TLM.TorchLM(engine)
    cfg = SystemCfg(device="cpu", index="flat",
                    precompute=PrecomputeCfg(wave=3, max_attempts_factor=2))
    with StorInfer.build(env["kb"], cfg, tmp_path / "s", n_pairs=6, lm=lm,
                         tokenizer=env["tok"]) as si:
        st = si.build_stats
        assert si.store.count == st.generated <= 6
        # every candidate, the tail of the wave that reached the target
        # included, is one generate_query call
        assert si.store.manifest_extra[STATE_KEY]["attempts"] == lm._seed
        assert st.generated + st.discarded <= lm._seed <= 6 * 2 + 100
        e = si.store.embeddings().take(np.arange(si.store.count))
        e = np.asarray(e, np.float32)
        assert _upper_sims(e).max() < cfg.gen.s_th_gen
        for row in range(si.store.count):
            q, r = si.store.get_pair(row)
            assert isinstance(q, str) and isinstance(r, str)


def test_make_pipeline_places_the_dedup_index(env):
    pipe = make_pipeline(SystemCfg(device="cpu"), SyntheticOracleLM(
        env["kb"]), env["tok"])
    assert pipe.device == "cpu" and isinstance(pipe.embedder, HashEmbedder)
    assert PrecomputePipeline(None, HashEmbedder(), env["tok"]).device == \
        "cuda"


_LAUNCH = r"""
import sys
from repro_torch.launch.precompute import main
main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ISOLATED")
"""


def test_launcher_builds_and_resumes_on_cpu(tmp_path):
    """``launch/precompute.py --device cpu``: a fresh build with its
    summary, then a rerun that finds the finished checkpoint and loads
    nothing of JAX or the reference."""
    argv = ["--dataset", "squad", "--n-docs", "6", "--n-pairs", "200",
            "--wave", "16", "--store", str(tmp_path / "s"), "--device",
            "cpu"]
    for extra, want in ((["--fresh"], "fresh store"),
                        ([], "resuming store")):
        out = subprocess.run([sys.executable, "-c", _LAUNCH] + argv + extra,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env=ENV)
        assert out.returncode == 0, out.stderr[-3000:]
        assert want in out.stdout and "ISOLATED" in out.stdout
        assert "build done: 200 rows" in out.stdout
        assert "dedup index ended flat" in out.stdout
        assert "serving index: flat" in out.stdout
