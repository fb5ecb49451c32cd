"""Mixture-of-Experts FFN with capacity-bounded sort-free dispatch, ported
from the JAX package's ``models/moe.py``: ``moe_ffn``, the scatter
dispatch that ``RunCfg.moe_impl`` selects by default, and
``moe_ffn_einsum``, the GShard grouped dispatch (``moe_impl="einsum"``).

Exact top-k routing with a per-call token capacity: tokens are scattered
into an (E, C, d) buffer by (expert, rank) slot, the experts run as one
batched product over every expert, and the results are gathered back and
combined with renormalised router weights. An assignment past its
expert's capacity is dropped (the residual stream carries the token).
Which assignments drop is the reference's choice exactly: the top-k keeps
the lower expert index on ties, and ranks follow an exclusive cumulative
sum over the flattened (token, k) order.

A config may route otherwise (``router="sigmoid"``: Nemotron-H's sigmoid
scores, chosen by score plus a correction bias) and hold a share of the
router's experts (``router_experts`` wide, ``n_experts`` of them held from
``first_expert`` on, as expert parallelism divides a layer): the layer
routes over all of them and computes the assignments to its own, with the
weights the whole top-k gives; what the other experts would add is not
there. Non-gated configs (``gated_mlp`` False) run ``down(act(up x))``
experts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models.layers import (_normal, activation, dense_init, mlp,
                                       mlp_init)


def moe_init(gen, cfg, dtype, device):
    d, ffe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts

    def ew(a, b):
        return _normal(gen, (E, a, b), a ** -0.5, dtype, device)

    p = {
        # the router is kept in f32, as in the reference
        "router": dense_init(gen, d, cfg.n_router, torch.float32, device),
        "experts": {"w1": ew(d, ffe), "w3": ew(d, ffe), "w2": ew(ffe, d)}
        if cfg.gated_mlp else {"w1": ew(d, ffe), "w2": ew(ffe, d)},
    }
    if cfg.router == "sigmoid":
        # the score-correction bias: it chooses, and weighs nothing
        p["router"]["bias"] = torch.zeros((cfg.n_router,),
                                          dtype=torch.float32, device=device)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, dtype, device, d_ff=cfg.shared_width)
    return p


def route(cfg, p, x2d):
    """x2d: (T, d) -> (weights (T,K) f32, idx (T,K), router probs (T,E)),
    over the router's ``n_router`` experts.

    The router product accumulates in f32 (the reference's
    ``preferred_element_type``): the inputs are widened, which is exact.
    ``jax.lax.top_k`` puts the lower index first among equal values and
    ``torch.topk`` promises no order, so the top-k is a stable descending
    sort. A sigmoid router sorts by its scores plus the correction bias,
    weighs by the scores alone, renormalised (Nemotron-H's
    ``norm_topk_prob``) and times ``routed_scale``."""
    w_r = p["router"]["w"].to(x2d.dtype)
    logits = x2d.float() @ w_r.float()
    K = cfg.experts_per_tok
    if cfg.router == "sigmoid":
        probs = torch.sigmoid(logits)
        _, idx = torch.sort(probs + p["router"]["bias"].float(), dim=-1,
                            descending=True, stable=True)
        idx = idx[:, :K]
        w = probs.gather(1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
        return w, idx, probs
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :K], idx[:, :K]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, idx, probs


def load_balance_loss(cfg, probs, idx):
    """Switch-style aux loss: E * sum_e(f_e * p_e), over the router's
    experts."""
    E = probs.shape[-1]
    me = probs.mean(dim=0)                                        # (E,)
    fe = F.one_hot(idx, E).float().mean(dim=(0, 1))
    return E * torch.sum(me * fe)


def capacity(cfg, n_tokens):
    c = int(n_tokens * cfg.experts_per_tok / cfg.n_router
            * cfg.moe_capacity_factor)
    return max(c, 8)


def dispatch_slots(cfg, idx, n_tokens):
    """(slot, valid, C) for each (token, k) assignment: slot = expert * C +
    rank within the expert, where rank counts the earlier assignments to
    that expert in flattened (token, k) order; an overflowing assignment
    gets slot E * C (one row past the buffer). Where the layer holds a
    share of the router's experts, E counts the held ones, an assignment
    to another expert is not valid and takes no rank, and while the span
    recorder records, the assignments and the held ones are counted on
    the device (``moe.routed``, ``moe.held``)."""
    E = cfg.n_experts
    C = capacity(cfg, n_tokens)
    flat_e = idx.reshape(-1)                                      # (T*K,)
    held = None
    if cfg.router_experts:
        local = flat_e - cfg.first_expert
        held = (local >= 0) & (local < E)
        flat_e = torch.where(held, local, 0)
        if trace.recording():
            trace.count("moe.routed", held.numel())
            trace.count("moe.held", held.sum())
    onehot = F.one_hot(flat_e, E)                                 # (T*K, E)
    if held is not None:
        onehot = onehot * held[:, None]
    rank = torch.cumsum(onehot, dim=0) - onehot                   # exclusive
    rank = rank.gather(1, flat_e[:, None])[:, 0]
    valid = rank < C if held is None else held & (rank < C)
    slot = torch.where(valid, flat_e * C + rank,
                       torch.full_like(flat_e, E * C))
    return slot, valid, C


def expert_ffn(cfg, experts, buf):
    """buf: (E, C, d) -> (E, C, d) through the expert MLPs: gated SiLU,
    or ``down(act(up x))`` where ``gated_mlp`` is False."""
    if not cfg.gated_mlp:
        return torch.bmm(activation(cfg, torch.bmm(buf, experts["w1"])),
                         experts["w2"])
    h1 = F.silu(torch.bmm(buf, experts["w1"]))
    h3 = torch.bmm(buf, experts["w3"])
    return torch.bmm(h1 * h3, experts["w2"])


def moe_ffn(cfg, p, x, with_aux=False):
    """x: (B, S, d) -> y. Exact top-k with capacity drop. The reference's
    ``moe_ffn`` also returns the aux loss, which only training reads:
    ``with_aux`` returns (y, ``load_balance_loss``) as it does."""
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    w, idx, probs = route(cfg, p, x2d)
    slot, valid, C = dispatch_slots(cfg, idx, T)
    E, K = cfg.n_experts, cfg.experts_per_tok

    # the reference's scatter (mode="drop") and gather (mode="fill") run
    # over a buffer with one extra row that takes the dropped assignments
    xk = x2d.repeat_interleave(K, dim=0) * valid[:, None].to(x.dtype)
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xk
    out = expert_ffn(cfg, p["experts"], buf[:E * C].reshape(E, C, d))
    out = torch.cat([out.reshape(E * C, d), x.new_zeros((1, d))])
    yk = out[slot] * valid[:, None].to(x.dtype)                   # (T*K, d)
    y = torch.sum(yk.reshape(T, K, d) * w[..., None].to(x.dtype), dim=1)

    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], x2d)
    y = y.reshape(B, S, d)
    return (y, load_balance_loss(cfg, probs, idx)) if with_aux else y


# ---------------------------------------------------------------------------
# GShard-style grouped einsum dispatch (``RunCfg(moe_impl="einsum")``)
# ---------------------------------------------------------------------------


def combine_tensor(cfg, idx, w, valid, C):
    """(g,K) expert ids and weights -> (g, E, C) f32 combine weights: an
    assignment lands at (its expert, its rank among the group's earlier
    assignments to that expert) unless that rank is C or more (dropped).
    ``jax.nn.one_hot`` gives a zero row for an out-of-range index, which
    the comparison with ``arange(C)`` reproduces."""
    E = cfg.n_experts
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    rank = torch.cumsum(onehot, dim=0) - onehot
    rank = rank.gather(1, flat_e[:, None])[:, 0].reshape(idx.shape)
    ok = valid & (rank < C)
    oh_e = F.one_hot(idx, E).float()                              # (g,K,E)
    oh_c = (rank[..., None] == torch.arange(C, device=idx.device)).float()
    return torch.einsum("gk,gke,gkc->gec", w * ok.float(), oh_e, oh_c)


def moe_ffn_einsum(cfg, p, x, group_size=2048):
    """GShard dispatch: the tokens in groups of ``group_size``, each with
    its own (g, E, C) combine tensor and capacity; dispatch, the experts
    and the combine are all products. Returns (y, aux loss), as the
    reference's."""
    B, S, d = x.shape
    T = B * S
    g = min(group_size, T)
    n = T // g
    if n * g != T:
        raise ValueError(f"moe_ffn_einsum: {T} tokens are not a whole number "
                         f"of groups of {g}")
    x2d = x.reshape(T, d)
    w, idx, probs = route(cfg, p, x2d)
    C = capacity(cfg, g)
    K = cfg.experts_per_tok
    ig, wg = idx.reshape(n, g, K), w.reshape(n, g, K)
    every = torch.ones_like(ig[0], dtype=torch.bool)
    comb = torch.stack([combine_tensor(cfg, ig[i], wg[i], every, C)
                        for i in range(n)])                    # (n,g,E,C)
    disp = (comb > 0).to(x.dtype)
    buf = torch.einsum("ngec,ngd->necd", disp, x2d.reshape(n, g, d))
    ex = p["experts"]
    h1 = F.silu(torch.einsum("necd,edf->necf", buf, ex["w1"]))
    h3 = torch.einsum("necd,edf->necf", buf, ex["w3"])
    out = torch.einsum("necf,efd->necd", h1 * h3, ex["w2"])
    y = torch.einsum("ngec,necd->ngd", comb.to(x.dtype), out).reshape(T, d)
    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], x2d)
    return y.reshape(B, S, d), load_balance_loss(cfg, probs, idx)
