"""Int8 gradient compression with error feedback, ported from the JAX
package's ``training/compression.py``.

Gradients are quantized to int8 with one symmetric scale per tensor, and
the quantization residual is carried in an error-feedback buffer added to
the next step's gradient (Seide et al. / EF-SGD): over many steps the
applied gradients sum to the true ones up to the last residual. On one
device there is no all-reduce to shrink; the step runs the same
arithmetic as the reference so that a distributed run can reduce the
int8 codes. ``torch.round`` rounds half to even, as ``jnp.round`` does,
so both packages give the same codes. The scale is per array of the
reference's layout: the reference holds a layer stack's leaves as one
(L, ...) array with one scale, so the port's per-layer leaves of a stack
share theirs. On a mesh the scale is the whole leaf's: the max over its
shards' ``abs().max()`` (a ``pmax``), and each shard is quantized with
it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import elementwise, parts
from repro_torch.models.convert import STACKS, tree_leaves, tree_map


def init_error_state(params):
    return tree_map(lambda p: elementwise(lambda t: torch.zeros(
        t.shape, dtype=torch.float32, device=t.device), p), params)


def quantize_int8(x, scale=None):
    """(int8 codes, f32 scale): scale = max|x| / 127 (at least 1e-12 / 127)
    unless given, codes = round-half-even(x / scale) clipped to
    [-127, 127]."""
    if scale is None:
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def _groups(tree):
    """Positions in ``tree_leaves(tree)`` that the reference holds as ONE
    array, each list sharing one scale: a layer stack's same-path leaves
    across its layers (the reference's stacked (L, ...) leaf), every other
    leaf alone."""
    if not isinstance(tree, dict):
        return [[i] for i, _ in enumerate(tree_leaves(tree))]
    groups, i = [], 0
    for k, v in tree.items():
        n = sum(1 for _ in tree_leaves(v))
        if k in STACKS and isinstance(v, list) and v:
            per = n // len(v)
            groups += [[i + layer * per + j for layer in range(len(v))]
                       for j in range(per)]
        else:
            groups += [[i + j] for j in range(n)]
        i += n
    return groups


def compress_grads(grads, err_state):
    """Returns (the dequantized grads every worker would see, the new
    error state), trees of the grads' shape. One scale per array of the
    reference's layout: a layer stack's leaves share theirs."""
    gs = [elementwise(lambda g, e: g.float() + e, g, e)
          for g, e in zip(tree_leaves(grads), tree_leaves(err_state))]
    dqs = [None] * len(gs)
    for group in _groups(grads):
        dev = parts(gs[group[0]])[0].device
        scale = torch.clamp(torch.stack([t.abs().max().to(dev)
                                         for i in group
                                         for t in parts(gs[i])]).max(),
                            min=1e-12) / 127.0
        for i in group:
            dqs[i] = elementwise(lambda g: dequantize(quantize_int8(
                g, scale.to(g.device))[0], scale.to(g.device)), gs[i])
    it_dq = iter(dqs)
    it_err = iter([elementwise(torch.sub, g, dq) for g, dq in zip(gs, dqs)])
    return (tree_map(lambda _: next(it_dq), grads),
            tree_map(lambda _: next(it_err), grads))
