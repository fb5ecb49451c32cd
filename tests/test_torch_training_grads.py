"""Parity of the port's training loss and gradients with the JAX reference,
for every arch the reference registers, on the CPU (the port's own
``nemotron-3-nano-30b-a3b`` has no JAX counterpart).

Each arch's ``reduced()`` config (two layers; zamba2 keeps its five, so
that the shared block runs three times) with the reference's weights
copied in; a seeded batch of tokens and labels (a few labels -1,
ignored), random frame embeddings for whisper, M-RoPE positions whose t,
h and w streams differ for qwen2-vl. The reference's
``jax.value_and_grad(lm_loss)`` is held against the port's ``lm_loss``
and ``torch.autograd.grad``, under ``attn_impl="naive"`` (the reference's
own tests) and ``"blockwise"`` with 16-row tiles, so that a 32-token
sequence runs several q and kv tiles through the hand-written backward.
Tolerances (f32): the loss and the MoE aux loss within 1e-5 relative,
each gradient leaf within 1e-4 of its own largest magnitude (measured:
1e-5 at most, zamba2's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs, reduced
from repro.models import model as M
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs as t_list_configs
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import model as TM
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves, tree_map)

# the port's archs that the reference registers too
ARCHS = [a for a in t_list_configs() if a in list_configs()]
B, S, TILE = 2, 32, 16
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4


def cfgs(arch, **kw):
    """(reference cfg, port cfg): the reduced arch, two layers unless
    hybrid."""
    cfg = reduced(get_config(arch))
    if cfg.family != "hybrid":
        kw.setdefault("n_layers", 2)
    cfg = dataclasses.replace(cfg, **kw)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return cfg, tcfg


def batches(cfg, seed=0, b=B, s=S):
    """(reference batch, port batch) from one numpy seed."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab[0, :3] = -1
    ref = {"tokens": tok, "labels": lab}
    if cfg.is_encoder_decoder:
        ref["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) \
            .astype(np.float32)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1] += 1
        pos[2] += 2
        ref["mrope_positions"] = pos
    port = {k: torch.from_numpy(v.copy()) if v.dtype == np.float32
            else torch.from_numpy(v.copy()).long() for k, v in ref.items()}
    return {k: jnp.asarray(v) for k, v in ref.items()}, port


def port_grads(tcfg, tparams, batch, run):
    leaves = list(tree_leaves(tparams))
    for t in leaves:
        t.requires_grad_(True)
    loss, met = TM.lm_loss(tcfg, tparams, batch, run)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss, met, tree_map(lambda _: next(it), tparams)


def assert_grads_close(got_tree, want_tree, tol=TOL_GRAD):
    """Port grads (a port tree) against reference grads (a pytree), leaf by
    leaf, each within ``tol`` of its own largest magnitude."""
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(got_tree))[0])
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want_tree))[0]
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float32) - w).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


def test_every_registered_arch_is_covered():
    assert sorted(ARCHS) == sorted(list_configs())
    assert set(t_list_configs()) - set(ARCHS) == {"nemotron-3-nano-30b-a3b"}


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_grad_match_reference(arch, impl):
    cfg, tcfg = cfgs(arch)
    params = M.init_model(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    batch, tbatch = batches(cfg)
    run = M.RunCfg(attn_impl=impl, remat=False, q_block=TILE, kv_block=TILE)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p: M.lm_loss(cfg, p, batch, run), has_aux=True))(params)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    tloss, tmet, tgrads = port_grads(
        tcfg, tparams, tbatch,
        TM.RunCfg(attn_impl=impl, q_block=TILE, kv_block=TILE))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=TOL_LOSS)
    np.testing.assert_allclose(float(tmet["moe_aux"]), float(met["moe_aux"]),
                               rtol=TOL_LOSS, atol=TOL_LOSS)
    assert (float(met["moe_aux"]) > 0) == (cfg.family == "moe")
    assert_grads_close(tgrads, grads)
