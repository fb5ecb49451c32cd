"""Parity of the port's single-device training with the JAX reference, on
the CPU: the blockwise attention and its hand-written backward, the
GShard MoE dispatch, AdamW, the train step (accumulation, compression),
the data pipeline, checkpoints in both directions, and the launcher.

Inputs are numpy draws from a seed; reference weights are copied into the
port (``params_from_jax``). Tolerances are stated per test: f32 pieces
within 1e-5 (the products sum in other orders in XLA and torch), whole
train steps within 1e-4 of the weights (a tenth of lr), bf16 params
within one bf16 ulp of the reference's. The per-arch loss and gradient
parity is in ``tests/test_torch_training_grads.py``.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.kb import build_kb
from repro.core.tokenizer import Tokenizer
from repro.models import blockwise as JB
from repro.models import model as M
from repro.models import moe as JMoe
from repro.training import checkpoint as CK
from repro.training import compression as GC
from repro.training import data as D
from repro.training import optimizer as O
from repro.training import train as T
from repro_torch.core.tokenizer import Tokenizer as TTokenizer
from repro_torch.models import blockwise as TB
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves, tree_map)
from repro_torch.training import checkpoint as TCK
from repro_torch.training import compression as TGC
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training import train as TT
from test_torch_training_grads import assert_grads_close, batches, cfgs

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# Adam's first steps move each weight by about lr times the sign of its
# gradient, so a weight whose gradient is near 0 moves by an amount that
# rounding decides: after whole train steps at lr 1e-3 the weights are
# held within a tenth of lr (measured: 4.3e-5 at most)
TOL_STEP = 1e-4
RUN = M.RunCfg(attn_impl="naive", remat=False)
TRUN = TM.RunCfg(attn_impl="naive")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(grad)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _tree_close(port_tree, ref_tree, tol=TOL):
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(port_tree))[0])
    want = jax.tree_util.tree_flatten_with_path(_np(ref_tree))[0]
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        if g.dtype.kind == "V":
            g = g.view(ml_dtypes.bfloat16)
        _close(g.astype(np.float32), w.astype(np.float32), tol)


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,offset,schedule,S_,T_", [
    (True, 0, "rect", 40, 40), (True, 0, "tri", 40, 40),
    (True, 7, "rect", 20, 27), (True, 7, "tri", 20, 27),
    (False, 0, "rect", 33, 50)])
def test_blockwise_gqa_output_and_grads_match_reference(causal, offset,
                                                        schedule, S_, T_):
    """16-row tiles over lengths that do not divide (padding in the last
    tile), G = 2, causal with and without a mask offset, both schedules,
    and the non-causal S != T of a cross-attention."""
    rng = np.random.default_rng(S_ + T_ + offset)
    q = rng.normal(size=(2, S_, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, T_, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T_, 2, 16)).astype(np.float32)
    w = rng.normal(size=(2, S_, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, mask_offset=offset, q_block=16, kv_block=16,
              schedule=schedule)
    out = JB.blockwise_gqa(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    grads = jax.grad(lambda *a: jnp.sum(JB.blockwise_gqa(*a, **kw) * w),
                     argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [_t(a, True) for a in (q, k, v)]
    tout = TB.blockwise_gqa(*ts, **kw)
    (tout * _t(w)).sum().backward()
    _close(tout.detach(), out)
    for t, g in zip(ts, grads):
        _close(t.grad, g)


def test_blockwise_gqa_matches_the_naive_attention_in_bf16():
    """bf16 inputs: the tiles round the scores and probabilities as the
    reference's do; the result stays within bf16 accuracy of the plain
    attention (5e-2, the B4 bf16 contract)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 40, 4, 16))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    got = TB.blockwise_gqa(q, k, v, q_block=16, kv_block=16)
    want = TM.flash_attention_plain(q, k, v, True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want.float(), 5e-2)


def test_blockwise_mla_output_and_grads_match_reference():
    """The absorbed MLA attention with a mask offset over 16-row tiles:
    its output and the gradients of q_c, q_r, ckv, krope and v_up against
    the reference's (which differentiates through its scan)."""
    rng = np.random.default_rng(3)
    B, S_, H, r, dr, Dv = 2, 40, 4, 32, 8, 16
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((B, S_, H, r), (B, S_, H, dr), (B, S_, r), (B, S_, dr),
             (r, H, Dv))]
    w = rng.normal(size=(B, S_, H, Dv)).astype(np.float32)
    kw = dict(scale=0.2, q_block=16, kv_block=16, mask_offset=3)

    def f(a, b, c, d, e):
        return jnp.sum(JB.blockwise_mla(a, b, c, d, v_up=e, **kw) * w)

    grads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    out = JB.blockwise_mla(*map(jnp.asarray, arrs[:4]),
                           v_up=jnp.asarray(arrs[4]), **kw)
    ts = [_t(a, True) for a in arrs]
    tout = TB.blockwise_mla(*ts[:4], v_up=ts[4], **kw)
    (tout * _t(w)).sum().backward()
    _close(tout.detach(), out)
    for t, g in zip(ts, grads):
        _close(t.grad, g, 2e-5)


def test_kernel_attention_refuses_autograd():
    """B4 has no backward in either package: ``attn_impl="kernel"`` on
    inputs that require grad raises instead of taking the plain path;
    without grad it is the plain attention on the CPU."""
    cfg, tcfg = cfgs("qwen3-1.7b")
    tparams = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                            dtype="float32", device="cpu")
    _, tb = batches(cfg)
    kernel = TM.RunCfg(attn_impl="kernel")
    for t in tree_leaves(tparams):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        TM.lm_loss(tcfg, tparams, tb, kernel)
    with torch.no_grad():
        a = TM.lm_loss(tcfg, tparams, tb, kernel)[0]
        b = TM.lm_loss(tcfg, tparams, tb, TRUN)[0]
    assert float(a) == float(b)
    with pytest.raises(ValueError, match="attn_impl"):
        TM.lm_loss(tcfg, tparams, tb, TM.RunCfg(attn_impl="flash"))


# ---------------------------------------------------------------------------
# MoE: the GShard einsum dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor,group", [(64.0, 32), (1.25, 16), (0.5, 96)])
def test_moe_ffn_einsum_matches_reference(factor, group):
    """Groups of 32, 16 and all 96 tokens; capacity factor 0.5 over a
    group of 96 drops assignments (capacity 12 per expert), as the
    reference's combine tensor does."""
    cfg, tcfg = cfgs("deepseek-v2-lite-16b", moe_capacity_factor=factor)
    p = JMoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = params_from_jax(_np(p), device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 48, cfg.d_model)) \
        .astype(np.float32)
    y, aux = JMoe.moe_ffn_einsum(cfg, p, jnp.asarray(x), group)
    ty, taux = TMoe.moe_ffn_einsum(tcfg, tp, _t(x), group)
    _close(ty, y)
    _close(taux, aux)
    idx = np.random.default_rng(2).integers(0, cfg.n_experts, (group, 2))
    w = np.random.default_rng(3).random((group, 2)).astype(np.float32)
    C = JMoe.capacity(cfg, group)
    comb = JMoe.combine_tensor(cfg, jnp.asarray(idx), jnp.asarray(w),
                               jnp.ones(idx.shape, bool), C)
    tcomb = TMoe.combine_tensor(tcfg, _t(idx).long(), _t(w),
                                torch.ones(idx.shape, dtype=torch.bool), C)
    assert np.array_equal(tcomb.numpy(), np.asarray(comb))
    if factor < 1:
        assert float(tcomb.sum()) < float(w.sum()) - 1e-3   # drops


def test_moe_einsum_lm_loss_and_grads_match_reference():
    cfg, tcfg = cfgs("grok-1-314b")
    params = M.init_model(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    batch, tb = batches(cfg, seed=4)
    run = M.RunCfg(attn_impl="naive", remat=False, moe_impl="einsum",
                   moe_group=16)
    (loss, _), grads = jax.value_and_grad(
        lambda p: M.lm_loss(cfg, p, batch, run), has_aux=True)(params)
    tparams = params_from_jax(_np(params), device="cpu")
    leaves = list(tree_leaves(tparams))
    for t in leaves:
        t.requires_grad_(True)
    tloss, _ = TM.lm_loss(tcfg, tparams, tb,
                          TRUN.replace(moe_impl="einsum", moe_group=16))
    tg = iter(torch.autograd.grad(tloss, leaves))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=TOL)
    assert_grads_close(tree_map(lambda _: next(tg), tparams), grads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_three_steps_match_reference():
    """bf16 params, f32 master, m and v; random f32 gradients, the first
    step clipped (norm above clip_norm) and inside the warmup. After each
    step: master, m and v within 1e-6 relative, the bf16 params within one
    bf16 ulp (they are casts of masters that may differ in the last f32
    bits), lr and the grad norm as the reference's."""
    cfg, tcfg = cfgs("qwen3-1.7b")
    params = M.init_model(jax.random.PRNGKey(3), cfg, dtype=jnp.bfloat16)
    tparams = params_from_jax(_np(params), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tparams))
    ocfg = O.AdamWCfg(lr=1e-2, warmup_steps=2, total_steps=10)
    opt, topt = O.init(params), TO.init(tparams)
    rng = np.random.default_rng(5)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                                  * (3.0 if step == 0 else 1e-4)), params)
        tg = params_from_jax(_np(g), device="cpu")
        params, opt, om = O.update(ocfg, g, opt, params)
        tparams, topt, tom = TO.update(ocfg, tg, topt, tparams)
        assert int(topt["step"]) == int(opt["step"]) == step + 1
        np.testing.assert_allclose(tom["lr"], float(om["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tom["grad_norm"]),
                                   float(om["grad_norm"]), rtol=1e-6)
        for key in ("master", "m", "v"):
            _tree_close(topt[key], opt[key], 1e-6)
        ulp = 2.0 ** -7
        got = params_to_numpy(tparams)
        for (path, w) in jax.tree_util.tree_flatten_with_path(
                _np(params))[0]:
            gv = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path] \
                .view(ml_dtypes.bfloat16).astype(np.float32)
            wv = w.astype(np.float32)
            assert np.all(np.abs(gv - wv) <= ulp * np.abs(wv) + 1e-30), path
    assert float(om["grad_norm"]) < ocfg.clip_norm


def test_lr_schedule_matches_reference():
    for ocfg in (O.AdamWCfg(warmup_steps=5, total_steps=50),
                 O.AdamWCfg(warmup_steps=0, total_steps=3),
                 O.AdamWCfg(schedule="constant", warmup_steps=4)):
        for step in (0, 1, 4, 5, 6, 27, 50, 80):
            np.testing.assert_allclose(
                TO.lr_at(ocfg, step),
                float(O.lr_at(ocfg, jnp.asarray(step, jnp.int32))),
                rtol=1e-6)


def test_weight_decay_only_on_matrices():
    """Zero gradients: a vector param stays, a matrix decays by
    lr * weight_decay * master. A layer's norm scale is a matrix in the
    reference's stacked layout (L, d), so it decays there, and in the
    port too; zamba2's unstacked shared block's scale does not."""
    p = {"embed": {"w": torch.ones((3, 2))},
         "final_norm": {"scale": torch.ones((2,))},
         "blocks": [{"ln": {"scale": torch.ones((2,))}} for _ in range(2)],
         "shared": {"ln": {"scale": torch.ones((2,))}}}
    ocfg = TO.AdamWCfg(lr=0.5, warmup_steps=0, weight_decay=0.1,
                       schedule="constant")
    g = tree_map(torch.zeros_like, p)
    p, opt, _ = TO.update(ocfg, g, TO.init(p), p)
    assert torch.equal(p["final_norm"]["scale"], torch.ones(2))
    assert torch.equal(p["shared"]["ln"]["scale"], torch.ones(2))
    for w in (p["embed"]["w"], p["blocks"][1]["ln"]["scale"]):
        _close(w, np.full(w.shape, 1 - 0.5 * 0.1))
    jp = jax.tree_util.tree_map(lambda a: jnp.ones(a.shape),
                                params_to_numpy(p))
    jp, _, _ = O.update(ocfg, jax.tree_util.tree_map(jnp.zeros_like, jp),
                        O.init(jp), jp)
    _tree_close(p, jp)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _ref_step(cfg, ocfg, accum=1, compress=None):
    return jax.jit(T.make_train_step(cfg, RUN, ocfg, accum=accum,
                                     compress=compress))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-72b"])
def test_train_steps_match_reference(arch):
    """Two steps of the whole train step (loss, grads, clipping, AdamW)
    in f32, and accumulation over 2 microbatches (qwen2-vl's M-RoPE
    positions split on their batch dim 1): the losses within 1e-5
    relative, the weights within ``TOL_STEP`` of the reference's, and
    after one step accum 2 within the reference's own accumulation
    tolerance (2e-3, ``test_training.py``) of accum 1."""
    cfg, tcfg = cfgs(arch)
    params = M.init_model(jax.random.PRNGKey(4), cfg, dtype=jnp.float32)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    batch, tb = batches(cfg, seed=6, b=4, s=16)
    out = {}
    for accum in (1, 2):
        step = _ref_step(cfg, ocfg, accum)
        tstep = TT.make_train_step(tcfg, TRUN, ocfg, accum=accum)
        p, o = params, O.init(params)
        tp = params_from_jax(_np(params), device="cpu")
        to = TO.init(tp)
        for i in range(2):
            p, o, m = step(p, o, batch)
            tp, to, tm = tstep(tp, to, tb)
            np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                       rtol=TOL)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(m["grad_norm"]), rtol=1e-4)
            if i == 0:
                out[accum] = [t.clone() for t in tree_leaves(tp)]
        _tree_close(tp, p, TOL_STEP)
    for a, b in zip(out[1], out[2]):       # the reference's own check
        _close(a, b, 2e-3)


def test_compressed_train_step_matches_reference():
    """One train step with the int8 compression hook in each package. The
    hook's input, the accumulated true gradient (dequantized grads plus
    the new residual), agrees within 1e-5 of each leaf's largest value.
    Its int8 codes then agree except where the two true gradients round
    to different sides of a half step: at most 1% of the elements, each
    by one quantum (max |g| / 127), and every other dequantized value
    within 2e-5 of the leaf's largest (the scales, max |g| / 127, agree
    that closely)."""
    cfg, tcfg = cfgs("qwen3-1.7b")
    params = M.init_model(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    batch, tb = batches(cfg, seed=7)
    seen = {}

    def hook(mod, key):
        def compress(grads, opt_state):
            dq, err = mod.compress_grads(grads, opt_state["grad_err"])
            seen[key] = (dq, err)
            return dq, dict(opt_state, grad_err=err)
        return compress

    T.make_train_step(cfg, RUN, ocfg, compress=hook(GC, "ref"))(
        params, dict(O.init(params), grad_err=GC.init_error_state(params)),
        batch)
    tp = params_from_jax(_np(params), device="cpu")
    TT.make_train_step(tcfg, TRUN, ocfg, compress=hook(TGC, "port"))(
        tp, dict(TO.init(tp), grad_err=TGC.init_error_state(tp)), tb)
    (dq, err), (tdq, terr) = seen["ref"], seen["port"]
    true = jax.tree_util.tree_map(lambda a, b: a + b, dq, err)
    assert_grads_close(tree_map(lambda a, b: a + b, tdq, terr), true, TOL)
    n = flips = 0
    for path, w in jax.tree_util.tree_flatten_with_path(_np(dq))[0]:
        g = dict(jax.tree_util.tree_flatten_with_path(
            params_to_numpy(tdq))[0])[path]
        quantum = float(np.abs(w).max()) / 127    # max |dq| = 127 scale
        # the scales agree to about 1e-5, so every code's value may
        # drift by that much of max |dq|; a flipped code by a quantum more
        drift = 2e-5 * 127 * quantum
        diff = np.abs(g - w)
        flip = diff > quantum / 2
        n += w.size
        flips += int(flip.sum())
        assert np.all(diff[~flip] <= drift), path
        assert np.all(np.abs(diff[flip] - quantum) <= drift), path
    assert flips <= 0.01 * n, (flips, n)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def test_int8_codes_match_reference_and_round_half_to_even():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 9)).astype(np.float32)
    q, s = GC.quantize_int8(jnp.asarray(x))
    tq, ts = TGC.quantize_int8(_t(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(q))
    assert float(ts) == float(s)
    # max |x| = 127 makes the scale exactly 1: the codes are the rounded x
    halves = np.array([127, 0.5, 1.5, 2.5, -2.5, -3.5, 126.5], np.float32)
    q, _ = GC.quantize_int8(jnp.asarray(halves))
    tq, _ = TGC.quantize_int8(_t(halves))
    assert tq.tolist() == np.asarray(q).tolist() == [127, 0, 2, 2, -2, -4,
                                                     126]


def test_error_feedback_invariant_and_reference_codes():
    """Ten steps of the same gradients: the applied grads sum to 10 x the
    true ones up to the final residual (the reference's own invariant),
    and every step's dequantized grads and residuals equal the
    reference's bit for bit, a layer stack's leaves sharing one scale as
    the reference's stacked leaf does."""
    rng = np.random.default_rng(0)
    # a layer stack: the port's per-layer list is the reference's stacked
    # leaf, one scale for both layers
    g_true = {"blocks": [{"w": rng.normal(size=(8,)).astype(np.float32)
                          * (1 + 9 * i)} for i in range(2)],
              "embed": {"w": rng.normal(size=(32, 8)).astype(np.float32)}}
    tg = tree_map(_t, g_true)
    jg = {"blocks": {"w": jnp.asarray(np.stack([b["w"] for b in
                                                g_true["blocks"]]))},
          "embed": {"w": jnp.asarray(g_true["embed"]["w"])}}
    err, terr = GC.init_error_state(jg), TGC.init_error_state(tg)
    applied = tree_map(torch.zeros_like, tg)
    for _ in range(10):
        dq, err = GC.compress_grads(jg, err)
        tdq, terr = TGC.compress_grads(tg, terr)
        for port, ref in ((tdq, dq), (terr, err)):
            for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(port)),
                            jax.tree_util.tree_leaves(ref)):
                assert np.array_equal(a, np.asarray(b))
        applied = tree_map(lambda a, d: a + d, applied, tdq)
    for a, g, e in zip(tree_leaves(applied), tree_leaves(tg),
                       tree_leaves(terr)):
        _close(a + e, 10 * g, 1e-4)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_data_batches_byte_identical():
    for step in (0, 7, 123):
        a = D.SyntheticLMData(500, 4, 16, seed=3).batch(step)
        b = TD.SyntheticLMData(500, 4, 16, seed=3).batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    texts = [d.text() for d in build_kb("squad", n_docs=4).docs]
    ref = D.TextFileData(texts, Tokenizer.from_texts(texts, max_vocab=512),
                         3, 24, seed=1)
    port = TD.TextFileData(texts, TTokenizer.from_texts(texts,
                                                        max_vocab=512),
                           3, 24, seed=1)
    assert ref.ids.tobytes() == port.ids.tobytes()
    for step in (0, 5):
        for k in ("tokens", "labels"):
            assert ref.batch(step)[k].tobytes() == port.batch(step)[k] \
                .tobytes()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _trained(cfg, tcfg, ocfg, n):
    """n reference steps and n port steps from the same weights and data
    (f32), with their train steps."""
    params = M.init_model(jax.random.PRNGKey(6), cfg, dtype=jnp.float32)
    data = D.SyntheticLMData(cfg.vocab_size, 4, 16, seed=0)
    step = _ref_step(cfg, ocfg)
    tstep = TT.make_train_step(tcfg, TRUN, ocfg)
    p, o = params, O.init(params)
    tp = params_from_jax(_np(params), device="cpu")
    to = TO.init(tp)
    for i in range(n):
        b = data.batch(i)
        p, o, _ = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, _ = tstep(tp, to, {k: torch.from_numpy(v).long()
                                   for k, v in b.items()})
    return (p, o, step), (tp, to, tstep), data


def test_checkpoints_restore_across_packages(tmp_path):
    """A checkpoint the reference writes restores in the port (and the
    port's next step equals the reference's next step from it), and a
    checkpoint the port writes restores in the reference: same keys,
    shapes and dtypes in ``meta.json``, and again the next steps agree
    within 1e-5."""
    cfg, tcfg = cfgs("qwen3-1.7b")
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    (p, o, step), (tp, to, tstep), data = _trained(cfg, tcfg, ocfg, 3)
    b = data.batch(3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    p_next, _, _ = step(p, o, jb)

    CK.Checkpointer(tmp_path / "ref").save(3, {"params": p, "opt": o},
                                          blocking=True)
    state, meta = TCK.Checkpointer(tmp_path / "ref").restore(device="cpu")
    assert meta["step"] == 3
    assert int(state["opt"]["step"]) == 3
    rp, ro, _ = tstep(state["params"], state["opt"], tb)
    _tree_close(rp, p_next, TOL_STEP)

    TCK.Checkpointer(tmp_path / "port").save(3, {"params": tp, "opt": to},
                                            blocking=True)
    ref_meta = json.loads((tmp_path / "ref" / "step_00000003" /
                           "meta.json").read_text())
    port_meta = json.loads((tmp_path / "port" / "step_00000003" /
                            "meta.json").read_text())
    assert port_meta["keys"] == ref_meta["keys"]
    assert sorted(p.name for p in (tmp_path / "port" /
                                   "step_00000003").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref" / "step_00000003")
               .iterdir())
    state, _ = CK.Checkpointer(tmp_path / "port").restore()
    sp = jax.tree_util.tree_map(jnp.asarray, state["params"])
    so = jax.tree_util.tree_map(jnp.asarray, state["opt"])
    sp_next, _, _ = step(sp, so, jb)
    _tree_close(tp, sp, 0.0)
    _tree_close(tstep(tp, to, tb)[0], sp_next, TOL_STEP)


def test_bf16_leaves_cross_packages_bit_for_bit(tmp_path):
    """A bf16 leaf is written as its raw 2-byte values with dtype
    "bfloat16", by either package, and read back with the same bits."""
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    CK.Checkpointer(tmp_path / "ref").save(1, {"w": jx}, blocking=True)
    st, meta = TCK.Checkpointer(tmp_path / "ref").restore(device="cpu")
    assert meta["keys"]["w"] == [[5, 3], "bfloat16"]
    assert st["w"].dtype == torch.bfloat16
    assert np.array_equal(st["w"].view(torch.int16).numpy(),
                          np.asarray(jx).view(np.int16))
    TCK.Checkpointer(tmp_path / "port").save(1, {"w": st["w"]},
                                            blocking=True)
    back, meta = CK.Checkpointer(tmp_path / "port").restore()
    assert meta["keys"]["w"] == [[5, 3], "bfloat16"]
    assert np.array_equal(back["w"].view(np.int16),
                          np.asarray(jx).view(np.int16))


def test_restore_then_step_equals_the_uninterrupted_run(tmp_path):
    """train(5) == train(3) -> save (async) -> restore -> train(2), in the
    port alone, bit for bit: the checkpoint holds the whole state, every
    leaf restored with its shape, dtype and values (the 0-dim step
    too)."""
    cfg, tcfg = cfgs("qwen3-1.7b")
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    _, (tp, to, tstep), data = _trained(cfg, tcfg, ocfg, 3)
    ck = TCK.Checkpointer(tmp_path / "ck")
    ck.save(3, {"params": tp, "opt": to})
    saved = [t.clone() for t in tree_leaves({"params": tp, "opt": to})]
    batch = [{k: torch.from_numpy(v).long() for k, v in
              data.batch(i).items()} for i in (3, 4)]
    a, ao = tp, to
    for b in batch:
        a, ao, _ = tstep(a, ao, b)
    ck.wait()
    st, meta = ck.restore(device="cpu")
    for x, y in zip(saved, tree_leaves(st)):     # the whole state, exactly
        assert x.dtype == y.dtype and torch.equal(x, y)
    c, co = st["params"], st["opt"]
    for b in batch:
        c, co, _ = tstep(c, co, b)
    for x, y in zip(tree_leaves(a), tree_leaves(c)):
        assert torch.equal(x, y)
    assert int(co["step"]) == int(ao["step"]) == 5


def test_checkpoint_crash_safety_keep_and_latest(tmp_path):
    ck = TCK.Checkpointer(tmp_path / "ck", keep=2)
    ck.save(1, {"x": torch.arange(4)}, blocking=True)
    # a stale .tmp dir from a "crash" must not be believed
    (tmp_path / "ck" / "step_00000002.tmp").mkdir()
    assert ck.latest_step() == 1
    state, _ = ck.restore()
    np.testing.assert_array_equal(state["x"], np.arange(4))
    # the reference's checkpointer agrees on what is there
    assert CK.Checkpointer(tmp_path / "ck").latest_step() == 1
    for s in (3, 4, 5):
        ck.save(s, {"x": torch.full((2,), s)})
    ck.wait()
    assert ck.steps() == [4, 5]
    assert int(ck.restore(4)[0]["x"][0]) == 4
    with pytest.raises(FileNotFoundError):
        TCK.Checkpointer(tmp_path / "empty").restore()


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def test_train_launcher_smoke_runs_and_resumes(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "3",
           "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "step 1 loss=" in out.stdout and out.stdout.strip().endswith(
        "done")
    assert TCK.Checkpointer(tmp_path / "ck").steps() == [2, 3]
    cmd[cmd.index("3")] = "4"
    out = subprocess.run(cmd + ["--compress"], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "resumed at step 3" in out.stdout


def test_train_launcher_refuses_the_mesh_paths():
    """The pod group's backend is never switched for the caller: NCCL on
    CPU processes raises; the production mesh on CUDA needs visible cards
    and never falls back to the CPU."""
    from repro_torch.launch import train as L
    with pytest.raises(ValueError, match="--backend nccl needs"):
        L.main(["--arch", "qwen3-1.7b", "--multipod", "--device", "cpu",
                "--backend", "nccl"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            L.main(["--arch", "qwen3-1.7b"])
