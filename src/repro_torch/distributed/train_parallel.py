"""The training forward and loss on a device mesh, one controller driving
every shard (``distributed/sharding.py``). The reference has no file for
this: GSPMD derives it from its param specs, its AdamW state specs and
the layout knobs of ``RunCfg``. Here it is written out as local functions
under ``smap``, each position running its block of the batch (split over
the batch axes by ``batch_shardings``).

Params are a tree of ``Sharded`` leaves laid out by ``param_specs``. At
use, per leaf:

* **FSDP.** A dim split over ``data``/``pod`` is all-gathered. The
  backward of that gather (copies and a concatenation, which autograd
  differentiates) sums the positions' gradients into each block: the
  reduce-scatter.
* **Tensor parallel on ``model``** where the specs split a layer and
  ``run.heads_sharded``: attention on the position's q heads (``wq``,
  ``wk``, ``wv`` column blocks; kv projections the specs keep whole, as
  with ``repeat_kv``, are repeated to the q heads and the position takes
  its own), MLA on its heads (``wq`` columns, ``wuk``/``wuv`` heads),
  ``wo`` on its rows, then a ``psum`` over ``model``; the dense MLP
  likewise (``w1``/``w3`` columns, ``w2`` rows).
* **``run.seq_parallel``** (the uniform stacks: dense, vlm, moe, ssm). The
  residual stream between blocks is split on the sequence over
  ``model``: the row-parallel products end in a reduce-scatter on the
  sequence (a ``psum`` and the position's slice) and the column-parallel
  inputs are all-gathered (Megatron-SP).
* **Vocab-split logits.** Where the embed or ``lm_head`` spec splits the
  vocab over ``model``, the lookup is masked and summed, the logits stay
  vocab-split and the cross-entropy takes its max and sums with
  ``pmax``/``psum``.
* **MoE** runs ``moe_parallel.moe_ffn_ep_sharded`` with ``moe_impl="ep"``,
  else the one-device dispatch on the gathered experts with the
  load-balance loss from the whole batch's statistics.
* **Everything else gathers** its ``model``-split leaves and computes as
  one device does: SSD (batch-only, which is ``pin_ssm``), the MLP or
  attention of a run that does not split them.

A parameter used at several positions has a copy (or a gathered block) at
each, and the gradient of a copy holds the part of the loss that went
through it, so a leaf's gradient is the sum of its copies' over the axes
its spec does not name (``psum_replicas``). The loss is normalised over
the valid labels of the whole (micro)batch and taken once per batch
block (at the first position of every other axis), so that the backward
starts from one scalar and no gradient counts a ``model`` replica twice.
Inside a pod group (``distributed/multihost.py``) the batch is this pod's
rows of the global microbatch: the valid-label count, the cross-entropy
sum and the MoE routing statistics are summed over pods
(``multihost.pod_sum``), so the loss is the global microbatch's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.moe_parallel import (load_balance_aux,
                                                  moe_ffn_ep_sharded)
from repro_torch.distributed.multihost import pod_mean, pod_sum
from repro_torch.distributed.sharding import (Sharded, _axes, _coord,
                                              all_gather, batch_shardings,
                                              elementwise, parts, place, pmax,
                                              pmean, psum, psum_replicas,
                                              smap)
from repro_torch.models import layers as Lyr
from repro_torch.models import model as M
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.models.convert import tree_leaves

AX = "model"
SP_FAMILIES = ("dense", "vlm", "moe", "ssm")   # the reference's scan stacks


@dataclasses.dataclass(frozen=True)
class _Plan:
    cfg: object
    run: object
    mesh: object
    n: int            # the model axis's size (1 without one)
    sp: bool          # the residual stream split on the sequence

    def split(self, w, dim) -> bool:
        """Whether leaf ``w`` is split over ``model`` on ``dim``."""
        return self.n > 1 and isinstance(w, Sharded) and \
            AX in _axes(w.spec[dim])


def _use(w, keep=()):
    """Leaf ``w`` as each position uses it: every dim split over axes
    outside ``keep`` all-gathered (a ``Sharded`` of per-position
    tensors); a replicated leaf as its copies."""
    if not isinstance(w, Sharded):
        return w
    out = w
    for dim, e in enumerate(w.spec):
        axes = _axes(e)
        if axes and not set(axes) <= set(keep):
            out = all_gather(out, axes, dim)
    return out


def _use_tree(tree, keep_model):
    """``_use`` over a params subtree; ``keep_model(path, leaf)`` says
    which leaves keep their ``model`` split."""
    def rec(path, t):
        if isinstance(t, dict):
            return {k: rec(path + (k,), v) for k, v in t.items()}
        keep = (AX,) if keep_model("/".join(path), t) else ()
        return _use(t, keep)
    return rec((), tree)


def _psum(plan, x):
    return psum(x, AX) if plan.n > 1 else x


def _chunk(plan, x):
    """A value replicated over ``model``: each position's sequence chunk."""
    return smap(lambda ctx, t: t.chunk(plan.n, 1)[ctx.index(AX)],
                plan.mesh, x)


def _full(plan, x):
    """The residual stream as a position's whole sequence."""
    return all_gather(x, AX, 1) if plan.sp else x


def _residual(plan, h, partial):
    """A layer's output in the residual's layout: a partial sum over
    ``model`` is reduced (onto the sequence chunks under ``sp``), a
    replicated value is cut into them under ``sp``."""
    if partial:
        h = _psum(plan, h)
    return _chunk(plan, h) if plan.sp else h


def _add(x, h):
    return elementwise(torch.add, x, h)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _gqa_local(cfg, run, ctx, p, x, positions, mrope, kv_x, *, hq, rep,
               causal):
    """Attention of ``hq`` q heads (the position's, or all) on its batch
    block; ``kv_x`` the cross-attention's keys' source (no RoPE). ``rep``:
    the kv projections are whole, so their heads are repeated to the q
    heads and the position takes its own. Returns the product with its
    ``wo`` rows (a partial sum when the heads are split)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    src = x if kv_x is None else kv_x
    q = Lyr.dense(p["wq"], x).reshape(B, S, hq, hd)
    k = Lyr.dense(p["wk"], src).reshape(B, src.shape[1], -1, hd)
    v = Lyr.dense(p["wv"], src).reshape(B, src.shape[1], -1, hd)
    if kv_x is None:
        q, k = Lyr.rope_q_k(cfg, p, q, k, positions, mrope)
    if rep:
        G = cfg.n_heads // cfg.n_kv_heads
        i = ctx.index(AX) * hq
        k = k.repeat_interleave(G, 2)[:, :, i:i + hq]
        v = v.repeat_interleave(G, 2)[:, :, i:i + hq]
    out = M._attend(q, k, v, causal, run)
    return out.reshape(B, S, hq * hd) @ p["wo"]["w"]


def _attention(plan, p, ln, x, positions, mrope, *, kv_x=None,
               causal=True):
    """Pre-norm attention (GQA, cross or MLA) of one layer: its output in
    the residual's layout, ``wo``'s bias added once."""
    cfg, run = plan.cfg, plan.run
    if cfg.use_mla and kv_x is None and "wuk" in p:
        return _mla(plan, p, ln, x, positions)
    tp = run.heads_sharded and plan.split(p["wq"]["w"], 1)
    rep = tp and not plan.split(p["wk"]["w"], 1)
    hq = cfg.n_heads // plan.n if tp else cfg.n_heads
    pl = _use_tree({k: v for k, v in p.items() if k != "wo"},
                   lambda path, w: tp and plan.split(w, len(w.spec) - 1))
    pl["wo"] = {"w": _use(p["wo"]["w"], (AX,) if tp else ())}

    def local(ctx, p, ln, x, positions, mrope, kv_x):
        h = Lyr.rmsnorm(ln, x, cfg.norm_eps)
        return _gqa_local(cfg, run, ctx, p, h, positions, mrope, kv_x,
                          hq=hq, rep=rep, causal=causal)

    h = smap(local, plan.mesh, pl, ln, _full(plan, x), positions, mrope,
             kv_x)
    h = _residual(plan, h, partial=tp)
    if "b" in p["wo"]:
        h = elementwise(lambda t, b: t + b, h, _use(p["wo"]["b"]))
    return h


def _mla(plan, p, ln, x, positions):
    """MLA on the position's heads when they are split (``wq`` columns,
    ``wuk``/``wuv`` heads, ``wo`` rows: ``mla_fullseq`` at the local head
    count gives the partial product), else on all of them."""
    cfg, run = plan.cfg, plan.run
    tp = run.heads_sharded and plan.split(p["wuk"], 1)
    keep = {"wq/w", "wuk", "wuv", "wo/w"} if tp else set()
    pl = _use_tree(p, lambda path, w: path in keep)
    lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // plan.n) if tp \
        else cfg

    def local(ctx, p, ln, x, positions):
        h = Lyr.rmsnorm(ln, x, cfg.norm_eps)
        return M.mla_fullseq(lcfg, p, h, positions, run=run)[0]

    h = smap(local, plan.mesh, pl, ln, _full(plan, x), positions)
    return _residual(plan, h, partial=tp)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _mlp(plan, p, ln, x):
    cfg = plan.cfg
    tp = plan.split(p["w1"]["w"], 1) and plan.split(p["w2"]["w"], 0)
    pl = _use_tree(p, lambda path, w: tp)

    def local(ctx, p, ln, x):
        return Lyr.mlp(cfg, p, Lyr.rmsnorm(ln, x, cfg.norm_eps))

    h = smap(local, plan.mesh, pl, ln, _full(plan, x))
    return _residual(plan, h, partial=tp)


def _moe(plan, p, ln, x):
    """Returns (the MoE output in the residual's layout, its aux loss)."""
    cfg, run, mesh = plan.cfg, plan.run, plan.mesh
    if run.moe_impl == "ep":
        if plan.n > 1 and not plan.split(p["experts"]["w1"], 0):
            raise ValueError(f"moe_impl='ep' needs the {cfg.n_experts} "
                             f"experts split over {plan.n} model shards")
        pl = {"router": _use_tree(p["router"], lambda *_: False),
              "experts": _use_tree(p["experts"], lambda *_: True)}
        if "shared" in p:
            pl["shared"] = _use_tree(p["shared"], lambda *_: False)
        h = smap(lambda ctx, ln, x: Lyr.rmsnorm(ln, x, cfg.norm_eps), mesh,
                 ln, x)
        y, (me, fe) = moe_ffn_ep_sharded(cfg, pl, h if plan.sp else
                                         _chunk(plan, h), mesh=mesh,
                                         ep_axis=run.ep_axis,
                                         batch_axes=run.batch_axes)
        return (y if plan.sp or plan.n == 1 else all_gather(y, AX, 1)), \
            load_balance_aux(cfg.n_experts, pod_mean(me), pod_mean(fe))
    if run.moe_impl not in ("einsum", "scatter"):
        raise ValueError(f"moe_impl must be 'scatter', 'einsum' or 'ep', "
                         f"got {run.moe_impl!r}")
    pl = _use_tree(p, lambda *_: False)

    def local(ctx, p, ln, x):
        h = Lyr.rmsnorm(ln, x, cfg.norm_eps)
        if run.moe_impl == "einsum":
            y, _ = Moe.moe_ffn_einsum(cfg, p, h, run.moe_group)
        else:
            y = Moe.moe_ffn(cfg, p, h)
        # the load-balance loss reads the whole batch's statistics
        _, idx, probs = Moe.route(cfg, p, h.reshape(-1, h.shape[-1]))
        return y, probs.mean(0), F.one_hot(idx, cfg.n_experts).float() \
            .mean((0, 1))

    y, me, fe = smap(local, mesh, pl, ln, _full(plan, x))
    me, fe = pmean(me, mesh.axis_names), pmean(fe, mesh.axis_names)
    aux = load_balance_aux(cfg.n_experts, pod_mean(me.shards.flat[0]),
                           pod_mean(fe.shards.flat[0]))
    return _residual(plan, y, partial=False), aux


# ---------------------------------------------------------------------------
# Layers and the stack
# ---------------------------------------------------------------------------


def _block(plan, p, x, positions, mrope, kind, enc_out):
    """One layer on the mesh (``block_fullseq``'s counterpart). Returns
    (x, the MoE aux loss or None). A layer pattern's ``experts`` and
    ``attn`` blocks have no mesh implementation."""
    cfg, run = plan.cfg, plan.run
    if kind not in ("ssm", "dense", "moe", "moe_dense0", "dec", "enc"):
        raise NotImplementedError(f"{cfg.name}: mesh training has no "
                                  f"{kind!r} block")
    if kind == "ssm":
        pl = _use_tree(p, lambda *_: False)

        def local(ctx, p, x):
            h = Lyr.rmsnorm(p["ln"], x, cfg.norm_eps)
            return Ssm.ssm_forward(cfg, p["ssm"], h,
                                   chunk=run.ssm_chunk or None)[0]

        h = smap(local, plan.mesh, pl, _full(plan, x))
        return _add(x, _residual(plan, h, partial=False)), None
    x = _add(x, _attention(plan, p["attn"], {"scale": _use(
        p["ln1"]["scale"])}, x, positions, mrope, causal=(kind != "enc")))
    if kind == "dec":
        x = _add(x, _attention(plan, p["xattn"],
                               {"scale": _use(p["lnx"]["scale"])}, x, None,
                               None, kv_x=enc_out, causal=False))
    ln2 = {"scale": _use(p["ln2"]["scale"])}
    if kind == "moe":
        h, aux = _moe(plan, p["moe"], ln2, x)
        return _add(x, h), aux
    return _add(x, _mlp(plan, p["mlp"], ln2, x)), None


def _layer(plan, p, x, positions, mrope, kind, enc_out=None):
    if plan.run.remat and torch.is_grad_enabled():
        return checkpoint(_block, plan, p, x, positions, mrope, kind,
                          enc_out, use_reentrant=False)
    return _block(plan, p, x, positions, mrope, kind, enc_out)


def _embed(plan, w, tokens):
    """The token lookup; a vocab split over ``model`` is looked up masked
    and summed."""
    if not plan.split(w, 0):
        return smap(lambda ctx, w, t: w[t], plan.mesh, _use(w), tokens)

    def local(ctx, w, t):
        V = w.shape[0]
        i = t - ctx.index(AX) * V
        ok = (i >= 0) & (i < V)
        return w[i.clamp(0, V - 1)] * ok[..., None].to(w.dtype)

    return psum(smap(local, plan.mesh, _use(w, (AX,)), tokens), AX)


def _encode(plan, params, frames):
    """Whisper's encoder on each position's frames (``model._encode``)."""
    cfg = plan.cfg
    scale = _use(params["enc_norm"]["scale"])

    def inp(ctx, f, s):
        B, Te, _ = f.shape
        f = f.to(s.dtype)
        pos = torch.arange(Te, device=f.device)[None].expand(B, Te)
        return f + M._sinusoid(Te, cfg.d_model, f.device).to(
            f.dtype)[None], pos

    x, pos = smap(inp, plan.mesh, frames, scale)
    for p in params["enc_blocks"]:
        x, _ = _block(plan, p, x, pos, None, "enc", None)
    return smap(lambda ctx, x, s: Lyr.rmsnorm({"scale": s}, x, cfg.norm_eps),
                plan.mesh, x, scale)


def _stack(plan, params, tokens, positions, mrope, frames):
    """Embed and run every layer of ``model.layer_plan``
    (``model._run_stack``). Returns (x, the MoE aux loss summed over
    layers)."""
    cfg, mesh = plan.cfg, plan.mesh
    x = _embed(plan, params["embed"]["w"], tokens)
    aux = torch.zeros((), device=mesh.devices.flat[0])
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(plan, params, frames)
        x = smap(lambda ctx, x: x + M._sinusoid(
            x.shape[1], cfg.d_model, x.device).to(x.dtype)[None], mesh, x)
    if plan.sp:
        x = _chunk(plan, x)
    for e in M.layer_plan(cfg):
        x, a = _layer(plan, M._params_at(params, e.params), x, positions,
                      mrope, e.kind, enc_out)
        if a is not None:
            aux = aux + a.to(aux.device)
    return _full(plan, x), aux


def _logits(plan, params, x):
    """The head on each position's whole sequence (``model.lm_logits``):
    (logits, vocab offset of the position's columns or None when whole)."""
    cfg, run = plan.cfg, plan.run
    tie = cfg.tie_embeddings
    w = params["embed"]["w"] if tie else params["lm_head"]["w"]
    vs = plan.split(w, 0 if tie else 1)
    keep = (AX,) if vs else ()
    head = {"w": _use(w, keep)}
    if not tie and "b" in params["lm_head"]:
        head["b"] = _use(params["lm_head"]["b"], keep)

    def local(ctx, fn, head, x):
        h = Lyr.rmsnorm({"scale": fn}, x, cfg.norm_eps)
        lg = h @ head["w"].T if tie else Lyr.dense(head, h)
        Vl = lg.shape[-1]
        off = ctx.index(AX) * Vl if vs else 0
        if cfg.padded_vocab != cfg.vocab_size:   # Megatron vocab padding
            cols = torch.arange(off, off + Vl, device=x.device)
            lg = lg.masked_fill(cols >= cfg.vocab_size, -1e30)
        return lg.float() if run.logits_f32 else lg

    return smap(local, plan.mesh, _use(params["final_norm"]["scale"]), head,
                x), vs


def _nll_sums(plan, logits, vs, labels):
    """Each position's summed cross-entropy over its valid labels (-1
    ignored), the vocab's max and sums taken over ``model`` when split."""
    mesh = plan.mesh

    def stats(ctx, lg):
        return lg.float().amax(-1, keepdim=True).detach()

    m = smap(stats, mesh, logits)
    if vs:
        m = pmax(m, AX)

    def part(ctx, lg, m, lab):
        lg = lg.float()
        Vl = lg.shape[-1]
        i = lab.clamp(min=0).long() - (ctx.index(AX) * Vl if vs else 0)
        ok = (i >= 0) & (i < Vl)
        pk = lg.gather(-1, i.clamp(0, Vl - 1)[..., None])[..., 0]
        return torch.exp(lg - m).sum(-1), pk * ok.float()

    se, pk = smap(part, mesh, logits, m, labels)
    if vs:
        se, pk = psum(se, AX), psum(pk, AX)

    def total(ctx, se, pk, m, lab):
        nll = torch.log(se) + m[..., 0] - pk
        return (nll * (lab >= 0).float()).sum()

    return smap(total, mesh, se, pk, m, labels)


def _owners(mesh, bspec):
    """The positions that hold one replica of each batch block: index 0
    on every axis the batch is not split over."""
    used = set(_axes(bspec))
    return [pos for pos in np.ndindex(mesh.devices.shape)
            if not any(_coord(mesh, pos)[a] for a in mesh.axis_names
                       if a not in used)]


def lm_loss(cfg, params, batch, run):
    """``model.lm_loss`` on ``run.mesh``: ``params`` a tree of ``Sharded``
    leaves, ``batch`` global tensors (split here per ``batch_specs``).
    Returns (loss on the mesh's first device, {"loss": the cross-entropy,
    "moe_aux"})."""
    mesh = run.mesh
    n = mesh.shape[AX] if AX in mesh.axis_names else 1
    S = batch["tokens"].shape[1]
    plan = _Plan(cfg, run, mesh, n, bool(
        run.seq_parallel and n > 1 and cfg.family in SP_FAMILIES and
        S % n == 0))
    placement = batch_shardings(batch, mesh)
    loc = place(batch, placement)
    positions = loc.get("positions")
    if positions is None:
        positions = smap(lambda ctx, t: torch.arange(
            t.shape[1], device=t.device)[None].expand(t.shape), mesh,
            loc["tokens"])
    x, aux = _stack(plan, params, loc["tokens"], positions,
                    loc.get("mrope_positions"), loc.get("frames"))
    logits, vs = _logits(plan, params, x)
    sums = _nll_sums(plan, logits, vs, loc["labels"])
    dev = mesh.devices.flat[0]
    ce = pod_sum(sum(sums.shards[pos].to(dev) for pos in _owners(
        mesh, placement["tokens"].spec[0])))
    n_valid = pod_sum((batch["labels"] >= 0).sum().to(dev).float())
    ce = ce / torch.clamp(n_valid, min=1.0)
    return ce + run.aux_coef * aux, {"loss": ce, "moe_aux": aux}


def grad_fn(cfg, run, params, batch):
    """(loss, metrics, grads) of ``lm_loss`` on the mesh: grads in
    ``tree_leaves(params)`` order, each an f32 ``Sharded`` of its leaf's
    spec (the copies' gradients summed, ``psum_replicas``; zeros for a
    leaf the loss does not reach, as ``jax.grad`` gives)."""
    leaves = list(tree_leaves(params))
    local = [t for leaf in leaves for t in parts(leaf)]
    for t in local:
        t.requires_grad_(True)
    try:
        loss, metrics = lm_loss(cfg, params, batch, run)
        gs = torch.autograd.grad(loss, local, allow_unused=True)
    finally:
        for t in local:
            t.requires_grad_(False)
    it = iter(gs)
    grads = []
    for leaf in leaves:
        g = elementwise(lambda t: _f32(next(it), t), leaf)
        grads.append(psum_replicas(g) if isinstance(g, Sharded) else g)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _f32(g, t):
    return torch.zeros(t.shape, dtype=torch.float32, device=t.device) \
        if g is None else g.float()
