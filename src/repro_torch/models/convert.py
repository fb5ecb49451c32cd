"""Parameters of the JAX package's model, as numpy arrays, into the port.

``params_from_jax`` takes the reference ``init_model`` pytree after
``jax.tree_util.tree_map(np.asarray, ...)`` — uniform layer stacks are
STACKED there, each ``blocks`` leaf shaped ``(L, ...)`` — and returns the
port's params (a list of per-layer dicts) holding the same numbers, so
both packages compute the same function. Layouts agree (``dense``
weights are ``(d_in, d_out)`` in both), so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_jax(tree, device="cpu"):
    def to_t(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = {k: _tree(v, to_t) for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    n_layers = _first_leaf(blocks).shape[0]
    out["blocks"] = [_tree(blocks, lambda a, i=i: to_t(np.asarray(a)[i]))
                     for i in range(n_layers)]
    return out


def _first_leaf(x):
    while isinstance(x, dict):
        x = next(iter(x.values()))
    return x
