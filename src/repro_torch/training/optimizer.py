"""AdamW with f32 master params, ported from the JAX package's
``training/optimizer.py``.

Optimizer state = {master (f32 copy of params), m, v (f32), step (int32,
a 0-dim tensor on the host)}: trees of the params' shape (dicts and
per-layer lists). The model params stay in their compute dtype (bf16 in
the reference's mixed precision); ``update`` writes each as a cast of its
f32 master after the Adam step. Unlike the reference, which returns new
trees, ``update`` writes the state and the params IN PLACE (no second
copy of a full-size model) and returns the same objects.

On a mesh the params are ``Sharded`` leaves, and master, m and v are laid
out as the params (``state_specs``: ZeRO-3, no replicated optimizer
memory): ``init`` and ``update`` work per shard, elementwise, and
``global_norm`` reads one replica of each block. The step stays on the
host, where the controller reads it.

Optional int8 gradient compression with error feedback lives in
``repro_torch.training.compression`` and is applied to the gradients
before ``update``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import blocks, elementwise, parts
from repro_torch.models.convert import STACKS, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"          # cosine | constant
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(ocfg: AdamWCfg, step) -> float:
    """Linear warmup, then cosine down to ``min_lr_frac`` of ``lr`` (or
    constant), in f32 arithmetic as the reference computes it."""
    f = np.float32
    step = f(int(step))
    warm = np.minimum(step / f(max(ocfg.warmup_steps, 1)), f(1.0))
    if ocfg.schedule == "constant":
        return float(f(ocfg.lr) * warm)
    prog = np.clip((step - f(ocfg.warmup_steps))
                   / f(max(ocfg.total_steps - ocfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(ocfg.lr) * warm
                 * (f(ocfg.min_lr_frac) + f(1 - ocfg.min_lr_frac) * cos))


def _zeros32(p):
    return elementwise(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                             device=t.device), p)


def init(params):
    return {
        "master": tree_map(lambda p: elementwise(
            lambda t: t.detach().float().clone(), p), params),
        "m": tree_map(_zeros32, params),
        "v": tree_map(_zeros32, params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def state_specs(param_specs_tree):
    """The optimizer state's specs given the params': master, m and v laid
    out as the params, the step replicated (the reference's)."""
    return {"master": param_specs_tree, "m": param_specs_tree,
            "v": param_specs_tree, "step": ()}


def state_shardings(param_shardings_tree):
    """``state_specs`` as placements (``sharding.place``): the step has
    none, it stays on the host."""
    return {"master": param_shardings_tree, "m": param_shardings_tree,
            "v": param_shardings_tree, "step": None}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, f32 (a 0-dim tensor on the
    first leaf's device); a ``Sharded`` leaf counts each block once."""
    total = None
    for g in tree_leaves(tree):
        for b in blocks(g):
            sq = torch.sum(b.float() ** 2)
            total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def _decays(params):
    """Per leaf, in ``tree_leaves`` order: whether weight decay applies,
    i.e. the leaf (the global one of a ``Sharded``) has two or more dims
    in the reference's layout, where
    every leaf of a layer stack (``convert.STACKS``) carries the stack's
    leading L axis. So a per-layer norm scale or bias decays, as it does
    in the reference; zamba2's unstacked shared block's do not."""
    out = []
    for k, v in params.items():
        extra = 1 if k in STACKS else 0
        out += [len(t.shape) + extra >= 2 for t in tree_leaves(v)]
    return out


@torch.no_grad()
def update(ocfg: AdamWCfg, grads, state, params):
    """One AdamW step: global-norm clipping at ``clip_norm``, bias-corrected
    moments, decoupled weight decay on tensors of two or more dimensions
    only (``_decays``), params written as casts of the f32 master. In
    place; returns (params, state, {"grad_norm": tensor, "lr": float})."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if ocfg.clip_norm else 1.0
    lr = lr_at(ocfg, step)
    b1, b2 = ocfg.b1, ocfg.b2
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    for leaves, decay in zip(zip(*(tree_leaves(t) for t in (
            grads, state["m"], state["v"], state["master"], params))),
            _decays(params)):
        for g, m, v, master, p in zip(*(parts(t) for t in leaves)):
            g = g.float() * (scale.to(g.device) if torch.is_tensor(scale)
                             else scale)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
            if decay:
                upd = upd + ocfg.weight_decay * master
            master.copy_(master - lr * upd)
            p.copy_(master)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
