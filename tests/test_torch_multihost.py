"""The pod axis with one process per host (``distributed/multihost.py``),
held to the reference on the CPU.

Two ``gloo`` processes (``tests/_multihost_worker.py``), each a (data 1,
model 2) CPU mesh, take rows ``[p::2]`` of the mesh training tests'
batch (``tests/_mesh_train.py``: the reduced config at f32, labels of -1
placed unevenly, so the two pods hold different numbers of valid labels).
Their loss and every all-reduced gradient are held to the reference's
one-device ``jax.value_and_grad`` and to the port's one-controller (pod 2,
data 1, model 2) mesh within ``TOL`` (1e-4). After two AdamW steps, with
and without gradient compression, the ranks hold the same params bit for
bit and within ``TOL_STEP`` (1e-5) of the one-controller run; rank 0's
checkpoint restores in one process and in the reference bit for bit.
Each spawn has a deadline, past which its ranks are killed, so a hung
rank fails its test. The launcher's pods split a host's cards as the
one-controller mesh does, and pods that would share a card under NCCL
raise.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _mesh_train import B, S, TILE, TOL, port_setup, reference
from repro.training import checkpoint as CK
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import multihost
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import params_to_numpy, tree_leaves
from repro_torch.training import checkpoint as TCK
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as O
from repro_torch.training import train as T
from test_torch_training_grads import assert_grads_close

ROOT = Path(__file__).resolve().parents[1]
TOL_STEP = 1e-5
SPAWN_S = 300               # a spawn's whole run
RUN_KW = dict(attn_impl="blockwise", q_block=TILE, kv_block=TILE,
              remat=False, seq_parallel=False)
OCFG = O.AdamWCfg(lr=1e-3, warmup_steps=1, eps=1e-4)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def _spawn(tmp_path, job):
    """Both ranks of ``job``; their results (rank 0, rank 1)."""
    job = dict(job, out=str(tmp_path),
               init=f"file://{tmp_path / 'rendezvous'}")
    torch.save(job, tmp_path / "job.pt")
    multihost.spawn([sys.executable, str(ROOT / "tests" /
                                         "_multihost_worker.py"),
                     str(tmp_path / "job.pt")], 2, SPAWN_S, tmp_path,
                    env=_env())
    return [torch.load(tmp_path / f"result{r}.pt", weights_only=False)
            for r in range(2)]


def _one_controller(tcfg, tparams, tbatch):
    """The port's (pod 2, data 1, model 2) mesh on one controller: one
    step's (loss, aux, grads) and the final params of two AdamW steps
    without and with compression."""
    mesh = make_production_mesh(multi_pod=True, devices=["cpu"] * 4)
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    run = SP.make_runcfg(tcfg, ShapeConfig("train", S, B, "train"), mesh,
                         **RUN_KW)
    pshard = Sh.param_shardings(tparams, mesh, tcfg)
    loss, met, grads = T.accumulate(T.make_grad_fn(tcfg, run),
                                    Sh.place(tparams, pshard), tbatch)
    out = {"loss": float(loss), "moe_aux": float(met["moe_aux"]),
           "grads": Sh.gather(grads)}

    def compress(grads, opt_state):
        dq, err = GC.compress_grads(grads, opt_state["grad_err"])
        return dq, dict(opt_state, grad_err=err)

    for name, fn in (("plain", None), ("compressed", compress)):
        params = Sh.place(tparams, pshard)
        opt = O.init(params)
        if fn is not None:
            opt["grad_err"] = GC.init_error_state(params)
        step = T.make_train_step(tcfg, run, OCFG, compress=fn)
        for _ in range(2):
            params, opt, m = step(params, opt, tbatch)
        out[name] = {"params": Sh.gather(params),
                     "grad_norm": float(m["grad_norm"])}
    return out


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_two_pods_match_reference_and_one_controller(arch, tmp_path):
    """qwen3-1.7b (GQA, tensor-parallel heads) and deepseek-v2-lite-16b
    (MLA, expert-parallel MoE, whose load-balance loss reads the global
    routing statistics) over two ``gloo`` processes."""
    want_loss, want = reference(arch, 1)
    tcfg, tparams, tbatch = port_setup(arch)
    r0, r1 = _spawn(tmp_path, {"cfg": tcfg, "params": tparams,
                               "batch": tbatch, "run_kw": RUN_KW,
                               "shape": ShapeConfig("train", S, B, "train"),
                               "ocfg": OCFG})
    one = _one_controller(tcfg, tparams, tbatch)

    for r in (r0, r1):
        assert r["mesh"] == {"data": 1, "model": 2} and r["rows"] == B // 2
        assert r["plain"]["same"] == r["compressed"]["same"] == [True, True]
    # the loss and gradients: every rank the global batch's
    assert r0["loss"] == r1["loss"] and _equal_trees(r0["grads"],
                                                     r1["grads"])
    np.testing.assert_allclose(r0["loss"], want_loss, rtol=TOL)
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=TOL)
    assert_grads_close(r0["grads"], want, TOL)
    assert_grads_close(r0["grads"], params_to_numpy(one["grads"]), TOL)
    np.testing.assert_allclose(r0["moe_aux"], one["moe_aux"], rtol=TOL,
                               atol=TOL)
    assert (r0["moe_aux"] > 0) == (tcfg.family == "moe")
    # two AdamW steps: bit for bit across ranks, near one controller's
    for name in ("plain", "compressed"):
        assert _equal_trees(r0[name]["params"], r1[name]["params"]), name
        np.testing.assert_allclose(r0[name]["grad_norm"],
                                   one[name]["grad_norm"], rtol=TOL)
        for x, y in zip(tree_leaves(r0[name]["params"]),
                        tree_leaves(one[name]["params"])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=TOL_STEP,
                                       atol=TOL_STEP, err_msg=name)
    # rank 0's checkpoint: in one process and in the reference
    state, meta = TCK.Checkpointer(tmp_path / "ck").restore(device="cpu")
    assert meta["step"] == 2
    assert _equal_trees(state["params"], r0["plain"]["params"])
    ref_state, _ = CK.Checkpointer(tmp_path / "ck").restore()
    got = jax.tree_util.tree_leaves(params_to_numpy(r0["plain"]["params"]))
    for x, y in zip(got, jax.tree_util.tree_leaves(ref_state["params"])):
        assert np.array_equal(np.asarray(y), x)


def test_launcher_trains_over_two_pods_and_resumes(tmp_path, capsys,
                                                   monkeypatch):
    """``launch/train.py --multipod --pods 2`` at the reduced
    deepseek-v2-lite-16b (MLA, EP) on two (data 1, model 2) CPU meshes:
    the mesh line names ``pod``, the ranks end with identical state,
    rank 0's checkpoint resumes in one process."""
    from repro_torch.launch import train as L
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ck = str(tmp_path / "ck")
    base = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt", ck]
    # its own session, so that a hung run's pods die with it
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *base,
         "--multipod", "--pods", "2", "--mesh", "1,2", "--steps", "2",
         "--compress"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=SPAWN_S)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-3000:]
    assert "mesh={'pod': 2, 'data': 1, 'model': 2}" in out
    assert "pods=2 replicas identical=True" in out
    assert out.strip().endswith("done")
    assert TCK.Checkpointer(ck).latest_step() == 2
    L.main(base + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and out.strip().endswith("done")


def test_the_pod_layer_is_the_identity_without_a_group():
    """Outside a process group: one pod, every row, sums of one term,
    gradients untouched, and a backend that cannot start raises."""
    assert not multihost.active() and multihost.n_pods() == 1
    assert multihost.pod_index() == 0
    batch = {"tokens": torch.arange(12).reshape(4, 3)}
    assert multihost.pod_rows(batch) is batch
    x = torch.tensor(3.0, requires_grad=True)
    assert multihost.pod_sum(x) is x and multihost.pod_mean(x) is x
    g = {"w": torch.ones(3)}
    assert multihost.all_reduce_grads(g) is g and torch.equal(g["w"],
                                                              torch.ones(3))
    assert multihost.replicas_identical(g)
    assert torch.equal(multihost.checksum(torch.ones(3)),
                       multihost.checksum(torch.ones(3)))
    assert not torch.equal(multihost.checksum(torch.tensor([1., 2.])),
                           multihost.checksum(torch.tensor([2., 1.])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl backend needs"):
            multihost.init("nccl", "file:///nonexistent", 0, 1)
    with pytest.raises(ValueError, match="no rendezvous"):
        multihost.init("gloo", rank=0, world_size=1)


@pytest.mark.parametrize("n_cards,pods,backend,want", [
    (8, 2, "nccl", [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (4, 4, "nccl", [[0], [1], [2], [3]]),
    (1, 2, "gloo", [[0], [0]]),
    (2, 4, "gloo", [[0], [0], [1], [1]]),
])
def test_pods_split_a_hosts_cards_as_the_one_controller_mesh(
        n_cards, pods, backend, want):
    """Each rank's cards: a block in rank order, the block the
    one-controller (pod 2, data 1, model n/2) mesh gives that pod; more
    pods than cards share them under gloo only."""
    got = [multihost.pod_cards(n_cards, r, pods, backend)
           for r in range(pods)]
    assert got == want
    if pods == 2 and n_cards >= pods:
        mesh = make_production_mesh(multi_pod=True, devices=[
            torch.device("cuda", i) for i in range(n_cards)])
        for p in range(2):
            assert [d.index for d in mesh.devices[p].flat] == got[p]
    if n_cards < pods:
        with pytest.raises(ValueError, match="NCCL refuses"):
            multihost.pod_cards(n_cards, 0, pods, "nccl")


def test_pods_that_cannot_split_the_cards_raise():
    """An uneven split raises, and a CPU pod's device is the CPU."""
    with pytest.raises(ValueError, match="do not split"):
        multihost.pod_cards(3, 0, 2, "nccl")
    with pytest.raises(ValueError, match="evenly"):
        multihost.pod_cards(2, 0, 3, "gloo")
    assert multihost.local_devices("cpu", "gloo") == [torch.device("cpu")]
