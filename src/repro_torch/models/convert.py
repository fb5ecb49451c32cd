"""Parameters of the JAX package's models, as numpy arrays, into the port
and back.

``params_from_jax`` takes a reference params pytree (``init_model``'s, or
``MiniLMEncoder.params``: ``embed``, stacked ``blocks``, ``final_norm``)
after ``jax.tree_util.tree_map(np.asarray, ...)`` — uniform layer stacks
are STACKED there, each ``blocks`` (and deepseek's ``dense0``, whisper's
``enc_blocks``) leaf shaped ``(L, ...)`` — and returns the port's params
(a list of per-layer dicts for each stack; zamba2's one ``shared`` block
stays a single layer's dict) holding the same numbers, so both packages
compute the same function. Layouts agree (``dense`` weights are
``(d_in, d_out)`` in both), so nothing is transposed. The tensors land on
``device``, "cuda" unless the caller asks for the CPU.

``params_to_numpy`` is the inverse: the port's params (or any tree of the
same shape: AdamW's master, m and v) as the reference's numpy pytree, each
stack's leaves stacked on a leading ``(L, ...)`` axis. That is the layout
checkpoints are written in, so a checkpoint of either package restores in
the other.

numpy has no bfloat16: a bf16 leaf travels as its raw 2-byte values (a
``V2`` array, which is what ``np.save`` writes and ``np.load`` reads back
for the reference's ``ml_dtypes.bfloat16`` arrays), and any 2-byte ``V``
array comes in as bf16.
"""
from __future__ import annotations

import numpy as np
import torch

STACKS = ("blocks", "dense0", "enc_blocks")   # the reference's stacked trees


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def to_tensor(a, device="cuda", copy=True) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor of its
    own on ``device`` (one copy); 2-byte ``V`` arrays (bf16 bits) as
    bf16. ``copy=False`` on the CPU shares a writable C-ordered array's
    memory."""
    a = np.asarray(a)
    bf16 = a.dtype.kind == "V" and a.dtype.itemsize == 2
    if bf16:
        a = a.view(np.int16)
    # torch takes a writable C-ordered array; jax's are read-only
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device, copy=copy)


def to_numpy(t) -> np.ndarray:
    """A tensor as a host numpy array of its own (one copy); bf16 as its
    raw 2-byte values (``V2``)."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.dtype("V2"))
    return h.numpy()


def params_from_jax(tree, device="cuda", copy=True):
    def to_t(a):
        return to_tensor(a, device, copy)

    out = {k: _tree(v, to_t) for k, v in tree.items() if k not in STACKS}
    for k in STACKS:
        if k in tree:
            out[k] = [_tree(tree[k], lambda a, i=i: to_t(np.asarray(a)[i]))
                      for i in range(_first_leaf(tree[k]).shape[0])]
    return out


def params_to_numpy(params):
    """The port's params tree -> the reference's numpy pytree: every leaf
    of a stack's per-layer list stacked on a leading axis."""
    out = {k: _tree(v, to_numpy) for k, v in params.items()
           if k not in STACKS}
    for k in STACKS:
        if k in params:
            layers = [_tree(lp, to_numpy) for lp in params[k]]
            out[k] = _stack_layers(layers)
    return out


def _stack_layers(layers):
    if isinstance(layers[0], dict):
        return {n: _stack_layers([lp[n] for lp in layers])
                for n in layers[0]}
    return np.stack(layers)


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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a port params tree (and of trees of the
    same shape in ``rest``), keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
