"""Training on a device mesh, on eight CPU shards: the rules, the
reference's own mesh step, AdamW, checkpoints and the launcher (the loss
and gradients of every arch: ``tests/test_torch_mesh_train_grads.py``
and ``..._grads_families.py``, through ``tests/_mesh_train.py``).

* ``RunCfg`` has the reference's fields and defaults; ``make_runcfg``,
  ``skip_reason`` and ``batch_struct`` match the reference's for all
  twelve configs, every shape and three meshes (``AbstractMesh``s);
  ``train_accum`` is ``build_cell``'s scaling; ``state_specs`` the
  reference's.
* The reference's own mesh step (``tests/_dist_train_reference.py``, a
  subprocess on eight forced host devices) fails under this JAX: its
  embedding gather is refused under the mesh's explicit axes.
* Two AdamW train steps leave params, master, m and v within 1e-5 of one
  device's; a compressed update (int8 codes with the whole leaf's scale,
  error feedback) on the mesh equals one device's on the same gradients.
* Checkpoints: a mesh's restored onto another mesh and onto one device,
  and the reference's (written from its (2, 4) mesh) onto the port's,
  bit for bit; the launcher trains on a mesh and resumes across meshes;
  ``--multipod`` raises naming the multi-host ROADMAP item.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from _mesh_train import (MESH_IDS, MESHES, cpu_mesh, mesh_run,  # noqa: F401
                         one_device, one_thread, port_setup)
from repro.configs import SHAPES, get_config, list_configs
from repro.launch import specs as JSP
from repro.models import model as JM
from repro.training import optimizer as JO
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import mesh as Meshes
from repro_torch.launch import specs as SP
from repro_torch.launch import train as L
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, tree_leaves
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as O
from repro_torch.training import train as T

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_configs()
TOL_STEP = 1e-5             # params, master, m, v after two AdamW steps
ABSTRACT = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model"))]


# ---------------------------------------------------------------------------
# RunCfg, make_runcfg, the train cell's knobs
# ---------------------------------------------------------------------------


def test_runcfg_has_the_reference_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JM.RunCfg)}
    got = {f.name: f.default for f in dataclasses.fields(TM.RunCfg)}
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == set()
    assert dataclasses.asdict(TM.SMOKE) == dataclasses.asdict(JM.SMOKE)


def _fields(run):
    d = dataclasses.asdict(run)
    mesh = d.pop("mesh")
    return d, None if mesh is None else dict(mesh.shape)


@pytest.mark.parametrize("mesh_shape,axes", ABSTRACT)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_runcfg_matches_reference(arch, shape, mesh_shape, axes):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jmesh = JAbstractMesh(mesh_shape, axes)
    mesh = Meshes.AbstractMesh(mesh_shape, axes)
    want = JSP.make_runcfg(cfg, SHAPES[shape], jmesh)
    got = SP.make_runcfg(tcfg, SHAPES[shape], mesh)
    assert _fields(got) == _fields(want)
    assert SP.skip_reason(tcfg, SHAPES[shape]) == \
        JSP.skip_reason(cfg, SHAPES[shape])
    jb = JSP.batch_struct(cfg, 4, 16)
    tb = SP.batch_struct(tcfg, 4, 16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()} == \
        {k: (s, str(d).replace("torch.", "")) for k, (s, d) in tb.items()}


def test_train_knobs_are_the_reference_cells():
    for name in ("TRAIN_ACCUM", "TRAIN_SP", "PREFILL_PIN_SSM",
                 "TRAIN_SSM_CHUNK", "PREFILL_SSM_CHUNK",
                 "FULL_ATTN_FAMILIES"):
        assert getattr(SP, name) == getattr(JSP, name), name
    # build_cell's train branch: x (512 // mesh size), capped by the rows
    # of each batch shard
    prod = Meshes.AbstractMesh((16, 16), ("data", "model"))
    assert SP.train_accum("qwen3-1.7b", prod, 256) == 4
    assert SP.train_accum("grok-1-314b", prod, 256) == 16
    node = Meshes.AbstractMesh((2, 2), ("data", "model"))
    assert SP.train_accum("qwen3-1.7b", node, 256) == 128
    assert SP.train_accum("qwen3-1.7b", node, 8) == 4
    run = SP.train_runcfg("qwen2-vl-72b", t_get_config("qwen2-vl-72b"),
                          SHAPES["train_4k"], prod)
    assert run.seq_parallel and run.remat and run.heads_sharded and \
        run.repeat_kv
    run = SP.train_runcfg("zamba2-1.2b", t_get_config("zamba2-1.2b"),
                          SHAPES["train_4k"], prod)
    assert run.ssm_chunk == 128 and not run.seq_parallel
    specs = Sh.param_specs(TM.init_model(t_get_config("qwen3-1.7b"),
                                         torch.Generator(), device="meta"),
                           prod, t_get_config("qwen3-1.7b"))
    jspecs = {k: v for k, v in JO.state_specs(specs).items()}
    assert O.state_specs(specs) == {k: (tuple(v) if k == "step" else v)
                                    for k, v in jspecs.items()}


# ---------------------------------------------------------------------------
# The reference's mesh step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_dist_train_reference.py"),
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return out


def test_reference_mesh_step_fails_under_this_jax(ref8):
    """The reference's launcher path (params and batch placed by its
    rules, ``make_runcfg``'s knobs, the loss gradient under ``jax.jit``)
    raises on a (2, 4) mesh: the embedding gather's output sharding is
    refused. The port's mesh step is held to its one-device gradient."""
    res = json.loads((ref8 / "mesh_step.json").read_text())
    for arch, r in res.items():
        assert not r["ran"], arch
        assert r["error"] == "ShardingTypeError", r
        assert "gather" in r["message"]


# ---------------------------------------------------------------------------
# Loss and gradients on the mesh
# ---------------------------------------------------------------------------


def test_mesh_global_norm_counts_each_block_once():
    tcfg, tparams, tbatch = port_setup("qwen3-1.7b")
    mesh = cpu_mesh((2, 4))
    placed = Sh.place(tparams, Sh.param_shardings(tparams, mesh, tcfg))
    np.testing.assert_allclose(float(O.global_norm(placed)),
                               float(O.global_norm(tparams)), rtol=1e-6)


# ---------------------------------------------------------------------------
# AdamW on the mesh
# ---------------------------------------------------------------------------


def _close_trees(pairs, tol=TOL_STEP):
    for name, a, b in pairs:
        for x, y in zip(tree_leaves(a), tree_leaves(Sh.gather(b))):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=tol,
                                       atol=tol, err_msg=name)


def _states(p1, o1, p2, o2):
    return [("params", p1, p2)] + [(k, o1[k], o2[k]) for k in
                                   ("master", "m", "v")]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "grok-1-314b"])
def test_two_adamw_steps_match_one_device(arch, mesh_shape):
    """Two train steps (accumulation 2, then 1) from the same state and
    batch: params, master, m and v within 1e-5 of one device's. Adam's
    normalisation turns any gradient far below ``eps`` into a step of
    about ``lr`` whose sign and size follow its last bits, and the mesh
    sums a gradient in another order than one device (1e-8 apart at f32):
    ``eps`` 1e-4 keeps the step proportional to such gradients, so the
    states agree to the gradients' rounding. (zamba2's SSD gradients agree
    to 1e-5 of their largest only, as in the one-device parity test, so
    two steps there are held by the gradient test above.)"""
    tcfg, tparams, tbatch = port_setup(arch)
    mesh = cpu_mesh(mesh_shape)
    run = mesh_run(tcfg, mesh, False)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1, eps=1e-4)

    def two_steps(params, run):
        opt = O.init(params)
        for accum in (2, 1):
            params, opt, m = T.make_train_step(tcfg, run, ocfg, accum=accum)(
                params, opt, tbatch)
        return params, opt, m

    placed = Sh.place(tparams, Sh.param_shardings(tparams, mesh, tcfg))
    p2, o2, m2 = two_steps(placed, run)
    p1, o1, m1 = two_steps(tparams, one_device(run))
    assert int(o2["step"]) == 2
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    _close_trees(_states(p1, o1, p2, o2))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_compressed_adamw_step_matches_one_device(mesh_shape):
    """The compressed update on the mesh: one device's gradients of a step
    (placed on the mesh as they are) through ``compress_grads`` (its scale
    the whole leaf's: the max over the shards) and ``update``, twice with
    the error feedback carried: the codes, the residual, params, master,
    m and v equal one device's (an int8 code is discontinuous, so the
    gradients in are the same ones; the mesh's gradients are held to one
    device's above)."""
    tcfg, tparams, tbatch = port_setup("deepseek-v2-lite-16b")
    mesh = cpu_mesh(mesh_shape)
    pshard = Sh.param_shardings(tparams, mesh, tcfg)
    placed = Sh.place(tparams, pshard)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    _, _, grads = T.accumulate(T.make_grad_fn(tcfg, TM.SMOKE), tparams,
                               tbatch)
    o1, o2 = O.init(tparams), O.init(placed)
    e1, e2 = GC.init_error_state(tparams), GC.init_error_state(placed)
    for _ in range(2):
        dq1, e1 = GC.compress_grads(grads, e1)
        dq2, e2 = GC.compress_grads(Sh.place(grads, pshard), e2)
        _close_trees([("codes", dq1, dq2), ("residual", e1, e2)], 0.0)
        _, _, m1 = O.update(ocfg, dq1, o1, tparams)
        _, _, m2 = O.update(ocfg, dq2, o2, placed)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-6)
    _close_trees(_states(tparams, o1, placed, o2))


# ---------------------------------------------------------------------------
# Checkpoints across meshes and packages
# ---------------------------------------------------------------------------


def _state_shardings(params, mesh, cfg):
    ps = Sh.param_shardings(params, mesh, cfg)
    return ps, {"params": ps, "opt": O.state_shardings(ps)}


def _equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_elastic_reshard_across_meshes_bit_for_bit(tmp_path):
    """A state trained one step on (2, 4), saved, restored onto (4, 2) and
    onto one device: every leaf equal; the step after either restore
    equals the uninterrupted one."""
    tcfg, tparams, tbatch = port_setup("qwen3-1.7b")
    mesh_a, mesh_b = cpu_mesh((2, 4)), cpu_mesh((4, 2))
    ps_a, _ = _state_shardings(tparams, mesh_a, tcfg)
    params = Sh.place(tparams, ps_a)
    opt = O.init(params)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    params, opt, _ = T.make_train_step(tcfg, mesh_run(tcfg, mesh_a, False),
                                       ocfg)(params, opt, tbatch)
    saved = Sh.gather({"params": params, "opt": opt})
    ck = CK.Checkpointer(tmp_path / "ck")
    ck.save(1, {"params": params, "opt": opt}, blocking=True)
    _, sh_b = _state_shardings(tparams, mesh_b, tcfg)
    st_b, meta = ck.restore(shardings=sh_b)
    assert meta["step"] == 1 and int(st_b["opt"]["step"]) == 1
    assert all(isinstance(t, Sh.Sharded) and t.mesh is mesh_b
               for t in tree_leaves(st_b["params"]))
    assert st_b["params"]["embed"]["w"].spec == Sh.param_specs(
        tparams, mesh_b, tcfg)["embed"]["w"]
    _equal(Sh.gather(st_b), saved)
    st_1, _ = ck.restore(device="cpu")
    _equal(st_1, saved)
    # the next step from either restore equals the uninterrupted one
    step_b = T.make_train_step(tcfg, mesh_run(tcfg, mesh_b, False), ocfg)
    step_a = T.make_train_step(tcfg, mesh_run(tcfg, mesh_a, False), ocfg)
    pa, _, ma = step_a(params, opt, tbatch)
    pb, _, mb = step_b(st_b["params"], st_b["opt"], tbatch)
    np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                               rtol=1e-6)
    for x, y in zip(tree_leaves(Sh.gather(pa)), tree_leaves(Sh.gather(pb))):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_reference_checkpoint_restores_onto_the_port_mesh(ref8):
    """The reference saved its (2, 4)-mesh state; it restores its own onto
    (4, 2) bit for bit, and the port restores it onto its (2, 4) and
    (4, 2) meshes bit for bit."""
    assert json.loads((ref8 / "ckpt_ok.json").read_text())[
        "restored_equal"]
    ck = CK.Checkpointer(ref8 / "ckpt")
    want, _ = ck.restore()
    want = CK._flatten(want)
    tcfg = t_reduced(t_get_config("qwen3-1.7b"))
    like = params_from_jax(ck.restore()[0]["params"], device="cpu")
    for shape in MESHES:
        _, sh = _state_shardings(like, cpu_mesh(shape), tcfg)
        st, _ = ck.restore(shardings=sh)
        assert isinstance(st["opt"]["m"]["blocks"][0]["attn"]["wq"]["w"],
                          Sh.Sharded)
        got = CK._flatten(CK._host(st))     # what a save would write
        assert got.keys() == want.keys()
        for k, a in want.items():
            assert np.array_equal(got[k], a), (shape, k)


def test_place_and_gather_round_trip():
    tcfg, tparams, _ = port_setup("deepseek-v2-lite-16b")
    mesh = cpu_mesh((2, 4))
    placed = Sh.place(tparams, Sh.param_shardings(tparams, mesh, tcfg))
    _equal(Sh.gather(placed), tparams)
    w = placed["blocks"][0]["moe"]["experts"]["w1"]
    assert w.spec == ("model", "data", None)
    assert w.shards[1, 2].shape == (2, 32, 64)
    again = Sh.place(placed, Sh.param_shardings(tparams, cpu_mesh((4, 2)),
                                                tcfg))
    _equal(Sh.gather(again), tparams)
    # batches, caches, a replicated value: the reference's rules
    batch = {"tokens": torch.arange(8 * 16).reshape(8, 16),
             "mrope_positions": torch.zeros(3, 8, 16, dtype=torch.long)}
    b = Sh.place(batch, Sh.batch_shardings(batch, mesh))
    assert b["tokens"].spec == ("data", None) and \
        b["mrope_positions"].spec == (None, "data", None)
    assert torch.equal(b["tokens"].shards[1, 3], batch["tokens"][4:])
    cache = TM.init_cache(tcfg, 4, 32, torch.float32, device="cpu")
    c = Sh.place(cache, Sh.cache_shardings(cache, mesh))
    assert c["ckv"].spec == (None, "data", "model", None)
    _equal(Sh.gather(c), cache)
    r = Sh.place(torch.tensor(3.0), Sh.replicated(mesh))
    assert r.spec == () and all(float(t) == 3.0 for t in Sh.parts(r))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_train_launcher_trains_on_a_mesh_and_resumes_across_meshes(
        tmp_path, monkeypatch, capsys):
    """The production path at the reduced deepseek (MLA, EP): a (2, 4)
    mesh of CPU shards, resumed on (4, 2), then on one device's (1, 1)
    production mesh; ``--multipod`` raises naming ROADMAP A14."""
    monkeypatch.setattr(L, "get_config",
                        lambda a: t_reduced(t_get_config(a)))
    ck = str(tmp_path / "ck")
    base = ["--arch", "deepseek-v2-lite-16b", "--device", "cpu", "--batch",
            "8", "--seq", "16", "--ckpt", ck, "--ckpt-every", "1"]
    L.main(base + ["--mesh", "2,4", "--steps", "2", "--compress"])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 4}" in out and "accum=4" in out
    L.main(base + ["--mesh", "4,2", "--steps", "3", "--compress"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and out.strip().endswith("done")
    L.main(base + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out and "resumed at step 3" \
        in out
    assert CK.Checkpointer(ck).latest_step() == 4
    with pytest.raises(ValueError, match="--backend nccl needs"):
        L.main(base + ["--multipod", "--backend", "nccl"])
