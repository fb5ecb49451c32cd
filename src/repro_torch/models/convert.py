"""Parameters of the JAX package's models, as numpy arrays, into the port.

``params_from_jax`` takes a reference params pytree (``init_model``'s, or
``MiniLMEncoder.params``: ``embed``, stacked ``blocks``, ``final_norm``)
after ``jax.tree_util.tree_map(np.asarray, ...)`` — uniform layer stacks
are STACKED there, each ``blocks`` (and deepseek's ``dense0``) leaf shaped
``(L, ...)`` — and returns the port's params (a list of per-layer dicts
for each stack; zamba2's one ``shared`` block stays a single layer's
dict) holding the same numbers, so both packages compute the same
function. Layouts agree (``dense``
weights are ``(d_in, d_out)`` in both), so nothing is transposed. The
tensors land on ``device``, "cuda" unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


STACKS = ("blocks", "dense0")     # the reference's stacked layer trees


def params_from_jax(tree, device="cuda"):
    def to_t(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = {k: _tree(v, to_t) for k, v in tree.items() if k not in STACKS}
    for k in STACKS:
        if k in tree:
            out[k] = [_tree(tree[k], lambda a, i=i: to_t(np.asarray(a)[i]))
                      for i in range(_first_leaf(tree[k]).shape[0])]
    return out


def _first_leaf(x):
    while isinstance(x, dict):
        x = next(iter(x.values()))
    return x


def tree_leaves(tree):
    """The tensors of a port params tree (dicts and lists), in a fixed
    order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree
