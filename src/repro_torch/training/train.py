"""Train step: loss -> grads (with microbatch accumulation) -> AdamW,
ported from the JAX package's ``training/train.py``, on one device or a
mesh.

``make_train_step(cfg, run, ocfg, accum, compress)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
over a batch of tensors ({"tokens", "labels"} and, per family, "frames",
"mrope_positions"). Gradient accumulation runs ``accum`` microbatches
(the batch split on its leading dim; ``mrope_positions`` (3, B, S) on
dim 1), summing f32 grads and dividing by ``accum``; the loss is the mean
of the microbatches' losses. Optional int8 gradient compression (error
feedback) is applied between accumulation and the optimizer — see
``repro_torch.training.compression``. The params and the optimizer state
are updated in place (``optimizer.update``).

The attention under autograd must be ``RunCfg(attn_impl="blockwise")``
(the reference's default) or ``"naive"``: the ``flash_attention`` kernel
has no backward and raises.

With ``run.mesh`` the params and the optimizer state are ``Sharded``
leaves (``sharding.place`` per ``param_shardings`` and
``optimizer.state_shardings``) and the loss and gradients are
``distributed/train_parallel.py``'s: the microbatches are the reference's
contiguous slices of the global batch, each then split over the batch
axes; each microbatch's loss is normalised over its own valid labels.
In a pod group (one process per host, ``distributed/multihost.py``) the
gradients are then summed over pods.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import multihost, train_parallel
from repro_torch.distributed.sharding import elementwise
from repro_torch.models import model as M
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.training import optimizer as O


def _split_batch(batch, accum):
    """(B, ...) -> ``accum`` microbatches of B/accum on every leaf's batch
    dim (dim 1 of ``mrope_positions``)."""
    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        dim = 1 if k == "mrope_positions" else 0
        B = v.shape[dim]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum {accum}")
        for i, part in enumerate(v.chunk(accum, dim=dim)):
            out[i][k] = part
    return out


def make_grad_fn(cfg, run):
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: grads a list in
    ``tree_leaves(params)`` order, in the params' dtypes (zeros for a
    param the loss does not reach, as ``jax.grad`` gives); on a mesh,
    ``train_parallel.grad_fn``'s f32 ``Sharded`` grads."""
    if run.mesh is not None:
        return functools.partial(train_parallel.grad_fn, cfg, run)

    def grad_fn(params, batch):
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = M.lm_loss(cfg, params, batch, run)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    return grad_fn


def _f32(g):
    return g.float()


def _acc(a, b):
    return a + b.float()


def accumulate(grad_fn, params, batch, accum=1):
    """(loss, metrics, grads): ``grad_fn`` over ``accum`` microbatches,
    f32 grads summed and divided by ``accum``, the loss the mean of the
    microbatches' (grads a tree of the params' shape)."""
    if accum == 1:
        loss, metrics, grads = grad_fn(params, batch)
        grads = [elementwise(_f32, g) for g in grads]
    else:
        grads, losses = None, []
        for mb in _split_batch(batch, accum):
            l, _, g = grad_fn(params, mb)
            losses.append(l)
            grads = [elementwise(_f32, x) for x in g] if grads is None \
                else [elementwise(_acc, a, b) for a, b in zip(grads, g)]
        grads = [elementwise(lambda g: g / accum, g) for g in grads]
        loss = torch.stack(losses).mean()
        metrics = {"loss": loss,
                   "moe_aux": torch.zeros((), device=loss.device)}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def make_train_step(cfg, run=M.RunCfg(), ocfg=O.AdamWCfg(), accum=1,
                    compress=None):
    """Inside a pod group (``distributed/multihost.py``) ``batch`` is this
    pod's rows of the global batch, ``run`` lays out its local mesh, and
    the accumulated gradients are summed over pods before compression and
    AdamW, so every pod applies the same update."""
    grad_fn = make_grad_fn(cfg, run)

    def train_step(params, opt_state, batch):
        if multihost.n_pods() > 1 and run.mesh is None:
            raise ValueError("a pod group trains on a local mesh: pass "
                             "RunCfg(mesh=...) (a (data, model) mesh of "
                             "this process's devices)")
        loss, metrics, grads = accumulate(grad_fn, params, batch, accum)
        multihost.all_reduce_grads(grads)
        if compress is not None:
            grads, opt_state = compress(grads, opt_state)
        params, opt_state, om = O.update(ocfg, grads, opt_state, params)
        return params, opt_state, dict(metrics, **om, loss=loss)

    return train_step
