"""Expert-parallel MoE over a mesh with all-to-all (port of the JAX
package's ``distributed/moe_parallel.py``).

Dispatch (DeepSeek-class thin-expert MoE; E % ep == 0):

  1. each shard routes its LOCAL tokens (router replicated, f32) and
     computes its own capacity C from its local token count,
  2. scatters them into an (E * C, d) capacity buffer (sort-free),
  3. all-to-all over the EP axis: (ep, E_local * C, d) -> each shard now
     holds the tokens of ITS E_local experts from every peer,
  4. the expert FFN over (E_local, ep * C, d),
  5. the reverse all-to-all, gather, weighted combine.

Tokens are split over the batch axes x the EP axis (batch rows where B
divides, the sequence over EP). Differentiable end to end (the
collectives are tensor ops across the shard list). Capacity overflow
drops assignments onto the residual stream, per shard, as the
reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.decode_attn import _batch_spec
from repro_torch.distributed.sharding import (Sharded, all_to_all, pmean,
                                              shard, smap)
from repro_torch.models import moe as Moe
from repro_torch.models.layers import mlp


def moe_ffn_ep(cfg, p, x, *, mesh, ep_axis="model", batch_axes=("data",)):
    """x: (B,S,d) -> (y (B,S,d) on x's device, aux loss). ``p["experts"]``
    leaves are full (E, ...) tensors, split over ``ep_axis`` on each call,
    or ``Sharded`` already split so (``shard(w, (ep_axis,), mesh)``).

    Requires cfg.n_experts % ep == 0 and S % ep == 0: tokens are
    sequence-split over the EP axis (each EP peer routes a disjoint token
    shard), so the all-to-all carries real traffic."""
    B, S, d = x.shape
    E, ep = cfg.n_experts, mesh.shape[ep_axis]
    if E % ep or S % ep:
        raise ValueError(f"expert parallel over {ep} shards needs E ({E}) "
                         f"and S ({S}) divisible by it")
    bspec = _batch_spec(mesh, batch_axes, B)
    xs = shard(x, (bspec, ep_axis), mesh)
    y, (me, fe) = moe_ffn_ep_sharded(cfg, p, xs, mesh=mesh,
                                     ep_axis=ep_axis, batch_axes=batch_axes)
    return y.with_spec((bspec, ep_axis)).full(x.device), \
        load_balance_aux(E, me, fe).to(x.device)


def load_balance_aux(E, me, fe):
    """The load-balance aux loss from the per-expert mean router
    probability ``me`` and assignment fraction ``fe``: E * sum(me * fe)."""
    return E * torch.sum(me * fe)


def moe_ffn_ep_sharded(cfg, p, xs, *, mesh, ep_axis="model",
                       batch_axes=("data",)):
    """``moe_ffn_ep`` on tokens already laid out: ``xs`` a ``Sharded`` whose
    shard at each position is its (B_local, S_local, d) block (batch rows
    over the batch axes where they split, the sequence over ``ep_axis``).
    Returns (y, a ``Sharded`` of the same layout, (me, fe)): the
    per-expert mean router probability and assignment fraction over the
    mesh's tokens, on the first position's device, from which
    ``load_balance_aux`` makes the aux loss. ``p`` leaves may be
    ``Sharded`` (the experts split over ``ep_axis`` on their leading dim,
    the rest replicated)."""
    E, K = cfg.n_experts, cfg.experts_per_tok
    ep = mesh.shape[ep_axis]
    d = xs.shards.flat[0].shape[-1]
    if E % ep:
        raise ValueError(f"expert parallel over {ep} shards needs E ({E}) "
                         "divisible by it")
    E_local = E // ep
    b_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    experts = {n: w if isinstance(w, Sharded) else shard(w, (ep_axis,), mesh)
               for n, w in p["experts"].items()}

    def dispatch(ctx, x, router):
        T = x.shape[0] * x.shape[1]
        x2d = x.reshape(T, d)
        w, idx, probs = Moe.route(cfg, {"router": router}, x2d)
        slot, valid, C = Moe.dispatch_slots(cfg, idx, T)
        # one extra row takes the dropped assignments (mode="drop")
        xk = x2d.repeat_interleave(K, dim=0) * valid[:, None].to(x.dtype)
        buf = x.new_zeros((E * C + 1, d))
        buf[slot] = xk
        me = probs.mean(dim=0)                                   # (E,)
        fe = F.one_hot(idx, E).float().mean(dim=(0, 1))
        return buf[:E * C].reshape(ep, E_local * C, d), w, slot, valid, \
            me, fe

    buf, w, slot, valid, me, fe = smap(dispatch, mesh, xs, p["router"])
    # send chunk i to peer i (the tokens for ITS experts)
    buf = all_to_all(buf, ep_axis)
    C = buf.shards.flat[0].shape[1] // E_local

    def run_experts(ctx, buf, w1, w2, w3):
        # rows grouped by (source shard, expert, slot) -> per expert
        b = buf.reshape(ep, E_local, C, d).transpose(0, 1)
        out = Moe.expert_ffn(cfg, {"w1": w1, "w2": w2, "w3": w3},
                             b.reshape(E_local, ep * C, d))
        out = out.reshape(E_local, ep, C, d).transpose(0, 1)
        return out.reshape(ep, E_local * C, d)

    out = smap(run_experts, mesh, buf, experts["w1"], experts["w2"],
               experts["w3"])
    out = all_to_all(out, ep_axis)

    def combine(ctx, out, x, w, slot, valid, shared):
        Bl, Sl = x.shape[:2]
        T = Bl * Sl
        # the gather's fill row (mode="fill")
        out = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
        yk = out[slot] * valid[:, None].to(x.dtype)
        y = torch.sum(yk.reshape(T, K, d) * w[..., None].to(x.dtype), dim=1)
        if cfg.n_shared_experts:
            y = y + mlp(cfg, shared, x.reshape(T, d))
        return y.reshape(Bl, Sl, d)

    y = smap(combine, mesh, out, xs, w, slot, valid, p.get("shared"))
    # the load-balance aux reads GLOBAL statistics: the per-expert mean
    # prob and assignment fraction pmean'd over the mesh (a caller that
    # trains over pods averages them over the pods too)
    axes = b_axes + (ep_axis,)
    me, fe = pmean(me, axes), pmean(fe, axes)
    return y, (me.shards.flat[0], fe.shards.flat[0])
