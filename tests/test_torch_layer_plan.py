"""The layer plan (``models/model.py`` ``layer_plan``): each config's
stack described once, read by init, the full-sequence stack, the cache
and decode on one device and by ``train_parallel`` on the mesh.

* The params tree of every registered arch, reduced and at full size on
  the meta device: the sha256 of its (key path, shape) sequence, and of
  ``cache_struct``'s (leaf, shape, dtype) sequence, pinned to the values
  of the code before the plan. ``storbench`` reads a cell's layout off
  ``init_model`` and draws its weights in that order, so a reordered
  tree would change the cells' weights.
* ``per_row_positions``' answer for every arch, and for the seq-sharded
  decode.
* The plan's entries: where the params sit, the cache leaves read at
  their index (zamba2's shared attention reads ``ak``/``av``; a layer
  pattern's leaves are indexed within their kind), the mixer names.
* Mesh training of a layer pattern refuses the block kinds it has no
  mesh implementation of, naming them.
"""
import hashlib

import pytest
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import mesh as Meshes
from repro_torch.models import model as M
from repro_torch.training import train as T

ARCHS = list_configs()

# (params hash, cache hash) of the code before the layer plan
LAYOUTS = {
    ("deepseek-v2-lite-16b", "reduced"): ("db67dda168166815",
                                          "9a7a09baa5647a5c"),
    ("deepseek-v2-lite-16b", "full"): ("f4740dd8147b7548",
                                       "9e957eb8b1c5544b"),
    ("grok-1-314b", "reduced"): ("333f0bc60306f96f", "eb76c5a41f79720c"),
    ("grok-1-314b", "full"): ("face85598fb6d524", "07a9053dd614a019"),
    ("llama3.2-3b", "reduced"): ("6b01b7e530988f93", "eb76c5a41f79720c"),
    ("llama3.2-3b", "full"): ("8ad81df41fcac160", "8e9efe336e32cdcf"),
    ("mamba2-130m", "reduced"): ("6b5ddb13a4add04d", "588f0896c98b7e52"),
    ("mamba2-130m", "full"): ("ad734a08381f874b", "90ea759b01d86001"),
    ("nemotron-3-nano-30b-a3b", "reduced"): ("2b1e9abc21f5d6f2",
                                             "b0f201a1a9e46cca"),
    ("nemotron-3-nano-30b-a3b", "full"): ("a40e9dfb8e2ab4f6",
                                          "8a415c7240260f2b"),
    ("qwen2-vl-72b", "reduced"): ("8c85134dd30f8551", "eb76c5a41f79720c"),
    ("qwen2-vl-72b", "full"): ("31c532716d300cbe", "704238ff5b89db2a"),
    ("qwen2.5-32b", "reduced"): ("8c85134dd30f8551", "eb76c5a41f79720c"),
    ("qwen2.5-32b", "full"): ("eaf64d737ced849f", "07a9053dd614a019"),
    ("qwen3-1.7b", "reduced"): ("637024ab1403c8cf", "eb76c5a41f79720c"),
    ("qwen3-1.7b", "full"): ("499b2bac54dd1bd0", "8e9efe336e32cdcf"),
    ("starcoder2-7b", "reduced"): ("0cfd3ce1b1bf19c3", "eb76c5a41f79720c"),
    ("starcoder2-7b", "full"): ("c6a7ab69dd4e7df6", "6de1f71549068eab"),
    ("storinfer-paper-1b", "reduced"): ("6b01b7e530988f93",
                                        "eb76c5a41f79720c"),
    ("storinfer-paper-1b", "full"): ("ae3f1838473d8deb", "b9b6a86529d1679a"),
    ("storinfer-paper-8b", "reduced"): ("6b6bb0392b0db473",
                                        "eb76c5a41f79720c"),
    ("storinfer-paper-8b", "full"): ("88ed8fe2061d4ea1", "ddb479c99bd772af"),
    ("whisper-base", "reduced"): ("006d39412309494e", "d3cf58a4812dca70"),
    ("whisper-base", "full"): ("16bb658a8bb76221", "b2d3ac5a0389d85a"),
    ("zamba2-1.2b", "reduced"): ("70eba6ad2628ba62", "e7dbeeb2b33e1d6a"),
    ("zamba2-1.2b", "full"): ("2ff2e44c761d2896", "3224320d105ebb99"),
}
PER_ROW = {"deepseek-v2-lite-16b": False, "grok-1-314b": True,
           "llama3.2-3b": True, "mamba2-130m": False,
           "nemotron-3-nano-30b-a3b": True, "qwen2-vl-72b": True,
           "qwen2.5-32b": True, "qwen3-1.7b": True, "starcoder2-7b": True,
           "storinfer-paper-1b": True, "storinfer-paper-8b": True,
           "whisper-base": False, "zamba2-1.2b": False}


def _cfg(arch, size):
    cfg = get_config(arch)
    return reduced(cfg) if size == "reduced" else cfg


def _walk(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _walk(v, path + (k,))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _walk(v, path + (i,))
    else:
        yield path, tuple(t.shape)


def _sha(items):
    return hashlib.sha256(repr(list(items)).encode()).hexdigest()[:16]


def test_every_registered_arch_is_pinned():
    assert {a for a, _ in LAYOUTS} == set(ARCHS) == set(PER_ROW)


@pytest.mark.parametrize("arch,size", sorted(LAYOUTS))
def test_params_and_cache_layout_pinned(arch, size):
    cfg = _cfg(arch, size)
    params = M.init_model(cfg, None, torch.float32, "meta")
    cache = M.cache_struct(cfg, 3, 40)
    assert (_sha(_walk(params)),
            _sha((n, s, str(d)) for n, (s, d) in cache.items())) == \
        LAYOUTS[arch, size]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_positions(arch):
    cfg = get_config(arch)
    mesh = Meshes.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    seq = M.RunCfg(decode_attn="seq_sharded", mesh=mesh)
    assert M.per_row_positions(cfg) is PER_ROW[arch]
    assert M.per_row_positions(reduced(cfg)) is PER_ROW[arch]
    assert M.per_row_positions(cfg, seq) is False


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_reads_each_cache_slot_once_and_every_param(arch):
    """Every (leaf, index) of the cache is read by one entry, every
    leaf's leading dim is the entries that read it, and every block of
    the params tree is some entry's."""
    cfg = reduced(get_config(arch))
    plan = M.layer_plan(cfg)
    assert M.layer_plan(cfg) is plan
    reads = [(leaf, j) for e in plan for _, leaf, j in e.cache]
    assert len(set(reads)) == len(reads)
    cache = M.cache_struct(cfg, 2, 8)
    assert sorted(reads) == sorted((n, j) for n, (s, _) in cache.items()
                                   for j in range(s[0]))
    params = M.init_model(cfg, None, torch.float32, "meta")
    held = {("blocks", i) for i in range(len(params["blocks"]))} | \
        {("dense0", i) for i in range(len(params.get("dense0", [])))} | \
        ({("shared",)} if "shared" in params else set())
    assert {e.params for e in plan} == held


def test_plan_shared_attention_and_pattern_indices():
    z = M.layer_plan(reduced(get_config("zamba2-1.2b")))   # 5 layers, k=2
    assert [(e.kind, e.params) for e in z] == [
        ("dense", ("shared",)), ("ssm", ("blocks", 0)), ("ssm", ("blocks", 1)),
        ("dense", ("shared",)), ("ssm", ("blocks", 2)), ("ssm", ("blocks", 3)),
        ("dense", ("shared",)), ("ssm", ("blocks", 4))]
    assert z[3].cache == (("k", "ak", 1), ("v", "av", 1))
    assert z[4].cache == (("h", "h", 2), ("conv", "conv", 2))
    assert all(e.mixer is None for e in z)
    n = M.layer_plan(reduced(get_config("nemotron-3-nano-30b-a3b")))
    assert "".join({"ssm": "M", "experts": "E", "attn": "*"}[e.kind]
                   for e in n) == "MEM*EM*E"
    assert [e.mixer for e in n] == ["ssm", "moe", "ssm", "attn", "moe",
                                    "ssm", "attn", "moe"]
    assert n[6].cache == (("k", "k", 1), ("v", "v", 1))
    assert n[5].cache == (("h", "h", 2), ("conv", "conv", 2))
    assert n[4].cache == () and n[4].params == ("blocks", 4)
    d = M.layer_plan(reduced(get_config("deepseek-v2-lite-16b")))
    assert [(e.kind, e.params) for e in d] == [
        ("moe_dense0", ("dense0", 0)), ("moe", ("blocks", 0)),
        ("moe", ("blocks", 1))]
    assert d[2].cache == (("ckv", "ckv", 2), ("krope", "krope", 2))


def test_mesh_training_refuses_a_layer_pattern_naming_the_block_kind():
    """Mesh training has no implementation of a layer pattern's MoE and
    attention blocks: the first it reaches is refused by name, not
    failed on a missing params key."""
    cfg = reduced(get_config("nemotron-3-nano-30b-a3b"))
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    mesh = Meshes.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    placed = Sh.place(params, Sh.param_shardings(params, mesh, cfg))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    run = M.RunCfg(attn_impl="naive", remat=False, mesh=mesh)
    with pytest.raises(NotImplementedError, match=r"'experts'") as e:
        T.make_grad_fn(cfg, run)(placed, {"tokens": tokens,
                                          "labels": tokens})
    assert cfg.name in str(e.value)
