"""The port's mesh paths against the JAX package's, on the CPU.

* The sharding rules: ``param_specs`` of all twelve configs (the
  reference's stacked layout, the port's per-layer layout on the meta
  device, and ``convert.params_to_numpy`` of a reduced model),
  ``cache_specs``, ``batch_specs``, ``heads_shardable``,
  ``batch_axes_of`` and ``n_batch_shards`` on a (2, 4) mesh and the
  production (16, 16) and (2, 16, 16) shapes (``AbstractMesh``s).
* The reference's mesh paths on eight forced host devices, forward only
  (``tests/_dist_reference.py``, one subprocess): the port on a (2, 4)
  mesh of eight CPU shards matches its sharded top-k (float; int8 with
  ``n_real``), seq-sharded GQA (the write in shard 2) and MLA decode,
  and expert-parallel MoE with per-shard capacity drops.
* In process: ``ShardedIndex`` against the reference's on one device and
  its ``FlatIndex``; ``StorInfer.open(..., mesh=)`` on the sharded tier
  across a §3.1 rebuild; greedy decoding with the seq-sharded decode
  against the reference's ``decode_step`` (qwen3-1.7b and
  deepseek-v2-lite, MLA, reduced); ``moe_ffn_ep``'s gradients against
  ``jax.grad`` of the reference's scatter ``moe_ffn``; the meshes'
  refusals.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import Mesh as JMesh

from repro.configs import get_config, list_configs, reduced
from repro.core.index import FlatIndex as JFlatIndex
from repro.core.index import ShardedIndex as JShardedIndex
from repro.distributed import sharding as JSh
from repro.launch import mesh as JMeshes
from repro.models import model as JM
from repro.models import moe as JMoe
from repro_torch.api import (EngineCfg, StorInfer, SystemCfg, make_index,
                             tier_of)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.embedder import HashEmbedder
from repro_torch.core.index import ShardedIndex
from repro_torch.core.kb import build_kb
from repro_torch.core.runtime import BatchedRuntimeCfg
from repro_torch.core.store import PrecomputedStore
from repro_torch.distributed import sharding as Sh
from repro_torch.distributed.decode_attn import (gqa_decode_seq_sharded,
                                                 mla_decode_seq_sharded)
from repro_torch.distributed.moe_parallel import moe_ffn_ep
from repro_torch.distributed.sharding import Sharded, shard
from repro_torch.distributed.topk import sharded_mips_topk
from repro_torch.launch import mesh as Meshes
from repro_torch.launch.serve import kb_pairs, write_kb_store
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _cpu_mesh(shape=(2, 4), axes=("data", "model")):
    return Meshes.make_mesh(shape, axes, devices=["cpu"] * int(np.prod(
        shape)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    """{"/".joined path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _stacked_meta(params):
    """The port's per-layer params (meta tensors) in the reference's
    stacked layout (what ``params_to_numpy`` does to real tensors)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {n: stack([lp[n] for lp in layers]) for n in layers[0]}
        return torch.stack(layers)
    return {k: stack(v) if isinstance(v, list) else v
            for k, v in params.items()}


@pytest.fixture(scope="module")
def meta_params():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = TM.init_model(t_get_config(name),
                                        torch.Generator(), device="meta")
        return cache[name]
    return get


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", list_configs())
def test_sharding_rules_match_reference(meta_params, arch, mesh_shape, axes):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jmesh = JAbstractMesh(mesh_shape, axes)
    mesh = Meshes.AbstractMesh(mesh_shape, axes)
    # params: the reference's stacked layout, shapes only
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    want = {p: tuple(s) for p, s in _flat(JSh.param_specs(
        shapes, jmesh, cfg)).items()}
    assert _flat(Sh.param_specs(shapes, mesh, tcfg)) == want
    # the port's own params on the meta device, stacked and per layer
    tp = meta_params(arch)
    assert _flat(Sh.param_specs(_stacked_meta(tp), mesh, tcfg)) == want
    for p, spec in _flat(Sh.param_specs(tp, mesh, tcfg)).items():
        parts = p.split("/")
        if parts[0] in ("blocks", "dense0", "enc_blocks"):
            ref = want["/".join([parts[0]] + parts[2:])]
            assert spec == ref[1:], p       # the layer dim replicates
        else:
            assert spec == want[p], p
    # through params_to_numpy, on the reduced arch's real weights
    rcfg = reduced(cfg)
    small = TM.init_model(t_reduced(tcfg), torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    rshapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                   rcfg))
    assert _flat(Sh.param_specs(params_to_numpy(small), mesh,
                                t_reduced(tcfg))) == \
        {p: tuple(s) for p, s in _flat(JSh.param_specs(rshapes, jmesh,
                                                       rcfg)).items()}
    # caches, batches, heads, batch axes
    for B, M in ((4, 160), (32, 256)):
        jc = JM.cache_struct(cfg, B, M)
        got = Sh.cache_specs(TM.cache_struct(tcfg, B, M), mesh)
        assert got == {n: tuple(s) for n, s in JSh.cache_specs(
            jc, jmesh).items()}
        batch = {"tokens": np.zeros((B, 16)), "labels": np.zeros((B, 16)),
                 "frames": np.zeros((B, 30, 8)),
                 "mrope_positions": np.zeros((3, B, 16))}
        assert Sh.batch_specs(batch, mesh) == {
            n: tuple(s) for n, s in JSh.batch_specs(batch, jmesh).items()}
    assert Sh.heads_shardable(tcfg, mesh) == JSh.heads_shardable(cfg, jmesh)
    assert Meshes.batch_axes_of(mesh) == JMeshes.batch_axes_of(jmesh)
    assert Meshes.n_batch_shards(mesh) == JMeshes.n_batch_shards(jmesh)


# ---------------------------------------------------------------------------
# The reference's mesh paths on eight devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_dist_reference.py"),
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


def test_sharded_topk_float_matches_reference(ref8):
    v, i = sharded_mips_topk(_t(ref8["topk_q"]), _t(ref8["topk_x"]), 7,
                             mesh=_cpu_mesh())
    _close(v, ref8["topk_v"], 1e-5)
    assert np.array_equal(i.numpy(), ref8["topk_i"])


def test_sharded_topk_int8_with_n_real_matches_reference(ref8):
    x8 = np.concatenate([ref8["i8_x"], np.zeros((3, 32), np.int8)])
    sc = np.concatenate([ref8["i8_scale"], np.ones(3, np.float32)])
    v, i = sharded_mips_topk(_t(ref8["topk_q"]), _t(x8), 7,
                             mesh=_cpu_mesh(), scales=_t(sc), n_real=61)
    _close(v, ref8["i8_v"], 1e-5)
    assert np.array_equal(i.numpy(), ref8["i8_i"])
    assert (i.numpy() < 61).all()


def test_reference_float_sharded_index_returns_padding_rows(ref8):
    """The reference pads a float store to a multiple of the shards with
    -1e4 rows and does not mask them: a query whose components sum below
    zero gets padded ids (>= N) back. The port masks them, so its answer
    is the flat scan's."""
    q, x = ref8["topk_q"], ref8["odd_x"]
    neg = q.sum(1) < 0
    assert neg.any() and (ref8["odd_i"][neg] >= 61).any()
    assert (ref8["odd_i"][~neg] < 61).all()
    v, i = ShardedIndex(x, _cpu_mesh()).search(q, 7)
    fv, fi = JFlatIndex(x).search(q, 7)
    assert np.array_equal(i, np.asarray(fi))
    _close(v, fv, 1e-5)
    _close(v[~neg], ref8["odd_v"][~neg], 1e-5)
    assert np.array_equal(i[~neg], ref8["odd_i"][~neg])


def test_seq_sharded_gqa_decode_matches_reference(ref8):
    """The write lands in shard 2 of 4 (position 20 of 32); batch rows
    split over data."""
    mesh = _cpu_mesh()
    args = [_t(ref8[f"gqa_{n}"]) for n in ("q", "k_new", "v_new", "kc",
                                           "vc")]
    out, kc, vc = gqa_decode_seq_sharded(*args, 20, mesh=mesh)
    assert isinstance(kc, Sharded) and kc.spec[:2] == ("data", "model")
    _close(out, ref8["gqa_out"], 1e-4)
    _close(kc.full(), ref8["gqa_kc2"], 1e-6)
    _close(vc.full(), ref8["gqa_vc2"], 1e-6)
    # only shard 2's slice changed: the other shards' rows are the input's
    assert not np.array_equal(ref8["gqa_kc2"], ref8["gqa_kc"])


def test_seq_sharded_mla_decode_matches_reference(ref8):
    mesh = _cpu_mesh()
    args = [_t(ref8[f"mla_{n}"]) for n in ("q_c", "q_r", "ckv_new",
                                           "krope_new", "ckv_c", "krope_c")]
    out, ckv, kr = mla_decode_seq_sharded(*args, 13, 0.125, mesh=mesh)
    _close(out, ref8["mla_out"], 1e-4)
    _close(ckv.full(), ref8["mla_ckv2"], 1e-6)
    _close(kr.full(), ref8["mla_krope2"], 1e-6)


def _moe_cfg():
    full = get_config("deepseek-v2-lite-16b")
    return dataclasses.replace(
        t_reduced(t_get_config("deepseek-v2-lite-16b")),
        moe_capacity_factor=full.moe_capacity_factor)


def _moe_params(a):
    return {"router": {"w": _t(a["moe_router"])},
            "experts": {n: _t(a[f"moe_{n}"]) for n in ("w1", "w2", "w3")},
            "shared": {n: {"w": _t(a[f"moe_s{n}"])}
                       for n in ("w1", "w2", "w3")}}


def test_expert_parallel_moe_with_drops_matches_reference(ref8):
    """At the full config's capacity factor each shard routes its 64 local
    tokens into capacity 20 and drops the same assignments."""
    assert int(ref8["moe_drops"]) > 0
    y, aux = moe_ffn_ep(_moe_cfg(), _moe_params(ref8), _t(ref8["moe_x"]),
                        mesh=_cpu_mesh())
    _close(y, ref8["moe_y"], 1e-4)
    np.testing.assert_allclose(float(aux), float(ref8["moe_aux"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------


def _rows(n, d=48, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _store(root, x, emb_dtype):
    st = PrecomputedStore(root, dim=x.shape[1], emb_dtype=emb_dtype,
                          shard_rows=256)
    st.add_batch(x, [f"q{i}" for i in range(len(x))],
                 [f"r{i}" for i in range(len(x))])
    st.flush()
    return st


@pytest.mark.parametrize("emb_dtype,n", [("float16", 512),
                                         ("float32", 513), ("int8", 513)])
def test_sharded_index_matches_reference(tmp_path, emb_dtype, n):
    """Against the reference ``ShardedIndex`` on one device and its
    ``FlatIndex``; an odd N pads the last shard (masked)."""
    x = _rows(n)
    st = _store(tmp_path / "s", x, emb_dtype)
    q = _rows(9, seed=3)
    mesh = Meshes.make_mesh((4,), ("model",), devices=["cpu"] * 4)
    idx = ShardedIndex(st.embeddings(), mesh)
    assert len(idx) == n and (idx.scales is not None) == (emb_dtype ==
                                                          "int8")
    v, i = idx.search(q, 5)
    jv, ji = JShardedIndex(st.embeddings(), JMesh(
        np.asarray(jax.devices()[:1]), ("model",))).search(q, 5)
    assert np.array_equal(i, np.asarray(ji))
    _close(v, jv, 1e-5)
    fv, fi = JFlatIndex(np.asarray(st.embeddings(), np.float32)).search(q, 5)
    if emb_dtype != "int8":         # the flat tier scans the dequantized
        assert np.array_equal(i, np.asarray(fi))
    _close(v, fv, 1e-2 if emb_dtype == "int8" else 1e-5)
    st.close()


def test_open_on_a_mesh_serves_the_sharded_tier_across_a_rebuild(tmp_path):
    kb = build_kb("squad", n_docs=4)
    path = tmp_path / "store"
    write_kb_store(path, kb, HashEmbedder(), 400, seed=1).close()
    mesh = Meshes.make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    cfg = SystemCfg(device="cpu", s_th_run=0.9,
                    index_kw={"shard_min_rows": 200},
                    batched=BatchedRuntimeCfg(add_misses=True,
                                              rebuild_every=1),
                    engine=EngineCfg(max_len=64, chunk=4))
    with StorInfer.open(path, cfg, mesh=mesh) as si:
        assert tier_of(si.index) == "sharded" and si.mesh is mesh
        q0, r0 = kb_pairs(kb)[0]
        rs = si.query_batch([q0, "zebra xylophone"], max_new=4)
        assert rs[0].hit and rs[0].response == r0 and not rs[1].hit
        b = si._batched
        assert b.stats.index_rebuilds >= 1
        assert tier_of(b.index) == "sharded" and len(b.index) == 401
        assert si.stats().index_tier == "sharded"
        r = si.query_batch(["zebra xylophone"], max_new=4)[0]
        assert r.hit and r.response == rs[1].response
    # one device on the model axis: the single-device tiers
    with StorInfer.open(path, cfg, mesh=Meshes.make_mesh(
            (1,), ("model",), devices=["cpu"])) as si:
        assert tier_of(si.index) == "flat"


def test_sharded_tier_needs_a_mesh_of_the_systems_device():
    x = _rows(64)
    with pytest.raises(ValueError, match="needs mesh="):
        make_index("sharded", x, device="cpu")
    idx = make_index("sharded", x, mesh=_cpu_mesh(), device="cpu")
    assert tier_of(idx) == "sharded" and len(idx) == 64
    with pytest.raises(ValueError, match="runs on its mesh's devices"):
        make_index("sharded", x, mesh=_cpu_mesh(), device="cuda")


def _decode_pair(arch):
    cfg = reduced(get_config(arch))
    tcfg = t_reduced(t_get_config(arch))
    params = JM.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return cfg, tcfg, params, tparams


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_seq_sharded_greedy_decode_matches_reference(arch):
    """Prefill, then 8 greedy tokens with ``RunCfg(decode_attn=
    "seq_sharded")`` on a (2, 4) mesh (batch rows over data, a 32-row f32
    cache over model), against the reference's one-device decode."""
    cfg, tcfg, params, tparams = _decode_pair(arch)
    B, S, M_ = 2, 6, 32
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    run = TM.RunCfg(attn_impl="naive", decode_attn="seq_sharded",
                    mesh=_cpu_mesh())
    jrun = JM.RunCfg(attn_impl="naive")
    lg, cache = JM.prefill(cfg, params, {"tokens": jnp.asarray(tokens)},
                           jrun, max_len=M_)
    tlg, tcache = TM.prefill(tcfg, tparams, _t(tokens), run, max_len=M_)
    assert all(isinstance(tcache[n], Sharded) for n in tcache)
    _close(tlg, lg, 1e-4)
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
    for step in range(8):
        assert np.array_equal(tlg[:, -1].argmax(-1).numpy()[:, None], tok)
        lg, cache = JM.decode_step(cfg, params, jnp.asarray(tok, jnp.int32),
                                   cache, jnp.asarray(S + step, jnp.int32),
                                   jrun)
        tlg, tcache = TM.decode_step(tcfg, tparams, _t(tok).long(), tcache,
                                     S + step, run)
        _close(tlg, lg, 1e-4)
        tok = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
    for n in cache:
        _close(tcache[n].full(), cache[n], 1e-4)


def test_decode_step_lays_out_a_plain_cache_and_keeps_dead_rows():
    """A cache from ``init_cache`` without ``run`` is laid out on the first
    seq-sharded step (in the same dict); a dead slot keeps its rows."""
    _, tcfg, _, tparams = _decode_pair("qwen3-1.7b")
    run = TM.RunCfg(decode_attn="seq_sharded", mesh=_cpu_mesh())
    cache = TM.init_cache(tcfg, 2, 32, torch.float32, device="cpu")
    cache["k"].normal_()
    before = cache["k"].clone()
    live = torch.tensor([True, False])
    _, out = TM.decode_step(tcfg, tparams, torch.tensor([[3], [4]]), cache,
                            5, run, live=live)
    assert out is cache and isinstance(cache["k"], Sharded)
    k = cache["k"].full()
    assert torch.equal(k[:, 1], before[:, 1])
    assert not torch.equal(k[:, 0, 5], before[:, 0, 5])
    placed = TM.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                           run=run)
    assert placed["k"].spec == (None, "data", "model", None, None)
    with pytest.raises(ValueError, match="needs RunCfg"):
        TM.decode_step(tcfg, tparams, torch.tensor([[3], [4]]), cache, 6,
                       run=TM.RunCfg(decode_attn="seq_sharded"))


def test_expert_parallel_moe_gradients_match_reference_scatter():
    """At capacity factor 64 (no drops) ``moe_ffn_ep`` on a (2, 4) mesh and
    the reference's one-device scatter ``moe_ffn`` compute the same y, aux
    and parameter gradients (the loss sums y squared and aux)."""
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                              moe_capacity_factor=64.0)
    tcfg = dataclasses.replace(t_reduced(t_get_config(
        "deepseek-v2-lite-16b")), moe_capacity_factor=64.0)
    p = JMoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)

    def loss(p):
        y, aux = JMoe.moe_ffn(cfg, p, jnp.asarray(x))
        return (y ** 2).sum() + aux

    want = jax.grad(loss)(p)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                         device="cpu")
    leaves = [t.requires_grad_() for t in _flat(tp).values()]
    y, aux = moe_ffn_ep(tcfg, tp, _t(x), mesh=_cpu_mesh())
    jy, jaux = JMoe.moe_ffn(cfg, p, jnp.asarray(x))
    _close(y, jy, 1e-4)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-4)
    ((y ** 2).sum() + aux).backward()
    got = {k: t.grad for k, t in _flat(tp).items()}
    assert all(t.grad is not None for t in leaves)
    for k, g in _flat(jax.tree_util.tree_map(np.asarray, want)).items():
        _close(got[k], g, 1e-3)


def test_meshes_refuse_what_they_cannot_place():
    with pytest.raises(ValueError, match="distinct cpu"):
        Meshes.make_local_mesh(model=4, device="cpu")
    assert Meshes.make_local_mesh(device="cpu").shape == {"data": 1,
                                                          "model": 1}
    with pytest.raises(ValueError, match="one type"):
        Meshes.make_mesh((2,), ("model",), devices=["cpu", "meta"])
    pod = Meshes.make_production_mesh(multi_pod=True, devices=["cpu"] * 4)
    assert pod.shape == {"pod": 2, "data": 1, "model": 2}
    with pytest.raises(ValueError, match="even number"):
        Meshes.make_production_mesh(multi_pod=True, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            Meshes.make_production_mesh()
    prod = Meshes.make_production_mesh(devices=["cpu"] * 4)
    assert prod.shape == {"data": 1, "model": 4}
    mesh = _cpu_mesh()
    t = torch.arange(64.).reshape(4, 16)
    s = shard(t, (None, ("data", "model")), mesh)
    assert torch.equal(s.full(), t) and s.shards[1, 2].shape == (4, 2)
    with pytest.raises(ValueError, match="does not split"):
        shard(torch.zeros(3, 5), ("model",), mesh)
