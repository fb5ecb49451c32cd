"""What the mesh training tests share: the reduced configs and batches,
the reference's one-device loss and grads (cached), the port's mesh run,
and the loss-and-gradients check (``check_loss_and_grads``) that
``tests/test_torch_mesh_train_grads.py`` runs for every arch.

The reference's own mesh step fails under this JAX (``tests/
test_torch_mesh_train.py::test_reference_mesh_step_fails_under_this_jax``),
so the port's is held to the reference's one-device
``jax.value_and_grad`` (the math GSPMD partitions) and to the port's own
one-device step: each arch's ``reduced()`` config (two layers, zamba2
five) at f32, labels of -1 placed unevenly across rows, shards and
microbatches. Tolerance ``TOL``: the loss within 1e-4 relative, each
gradient leaf within 1e-4 of its own largest magnitude (measured: 2e-6
at most, zamba2's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.training.train import _split_batch as j_split_batch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import mesh as Meshes
from repro_torch.launch import specs as SP
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
from repro_torch.training import train as T
from test_torch_training_grads import assert_grads_close, batches, cfgs

MESHES = [(2, 4), (4, 2)]
MESH_IDS = ["2x4", "4x2"]
B, S, TILE = 8, 32, 16
TOL = 1e-4                  # loss (relative) and each grad leaf (of its max)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eight shards' tiny ops: one intra-op thread each runs them faster
    than a pool that several test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return Meshes.make_mesh(shape, ("data", "model"),
                            devices=["cpu"] * int(np.prod(shape)))


def uneven(batch):
    """Labels of -1 placed unevenly: part of row 0, the tail of row 3, all
    of row 6 (other shards, other microbatches)."""
    lab = np.array(batch["labels"])
    lab[0, :5] = -1
    lab[3, 10:] = -1
    lab[6, :] = -1
    return lab


_PARAMS, _REF = {}, {}


def ref_params(arch):
    """The reference's f32 params of the arch's reduced config (cached)."""
    if arch not in _PARAMS:
        cfg, _ = cfgs(arch)
        _PARAMS[arch] = JM.init_model(jax.random.PRNGKey(1), cfg,
                                      dtype=jnp.float32)
    return _PARAMS[arch]


def reference(arch, accum):
    """The reference's one-device loss and grads at accumulation
    ``accum`` (contiguous microbatches, grads averaged), cached."""
    if (arch, accum) not in _REF:
        cfg, _ = cfgs(arch)
        params = ref_params(arch)
        batch, _ = batches(cfg, b=B, s=S)
        batch["labels"] = jnp.asarray(uneven(batch))
        run = JM.RunCfg(attn_impl="naive", remat=False)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: JM.lm_loss(cfg, p, b, run)[0]))
        micro = j_split_batch(batch, accum)
        losses, grads = [], None
        for i in range(accum):
            loss, g = vg(params, {k: v[i] for k, v in micro.items()})
            losses.append(float(loss))
            grads = g if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g)
        grads = jax.tree_util.tree_map(lambda g: g / accum, grads)
        _REF[arch, accum] = (float(np.mean(losses)), grads)
    return _REF[arch, accum]


def port_setup(arch):
    cfg, tcfg = cfgs(arch)
    params = ref_params(arch)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    _, tbatch = batches(cfg, b=B, s=S)
    tbatch["labels"] = torch.from_numpy(uneven(tbatch)).long()
    return tcfg, tparams, tbatch


def one_device(run):
    """The mesh run's knobs on one device (expert parallel's dispatch is
    the scatter there)."""
    return run.replace(mesh=None, moe_impl="scatter" if run.moe_impl == "ep"
                       else run.moe_impl)


def mesh_run(tcfg, mesh, sp):
    return SP.make_runcfg(tcfg, ShapeConfig("train", S, B, "train"), mesh,
                          attn_impl="blockwise", q_block=TILE, kv_block=TILE,
                          remat=sp, seq_parallel=sp)


def check_loss_and_grads(arch, mesh_shape, sp, accum):
    """The mesh's loss and every gradient against one device's and the
    reference's (the tolerance ``TOL``)."""
    want_loss, want = reference(arch, accum)
    tcfg, tparams, tbatch = port_setup(arch)
    mesh = cpu_mesh(mesh_shape)
    run = mesh_run(tcfg, mesh, sp)
    one = T.accumulate(T.make_grad_fn(tcfg, one_device(run)),
                       tparams, tbatch, accum)
    pshard = Sh.param_shardings(tparams, mesh, tcfg)
    placed = Sh.place(tparams, pshard)
    loss, met, grads = T.accumulate(T.make_grad_fn(tcfg, run), placed,
                                    tbatch, accum)
    assert all(isinstance(g, Sh.Sharded) and g.spec == s.spec
               for g, s in zip(tree_leaves(grads), tree_leaves(pshard)))
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
    np.testing.assert_allclose(float(loss), float(one[0]), rtol=TOL)
    full = Sh.gather(grads)
    assert_grads_close(full, want, TOL)
    assert_grads_close(full, jax.tree_util.tree_map(
        np.asarray, params_to_numpy(one[2])), TOL)
    if accum == 1:
        np.testing.assert_allclose(float(met["moe_aux"]),
                                   float(one[1]["moe_aux"]), rtol=TOL,
                                   atol=TOL)
        assert (float(met["moe_aux"]) > 0) == (tcfg.family == "moe")
