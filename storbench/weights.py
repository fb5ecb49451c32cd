"""Weights made by the benchmark from ``--seed``, on the device, in one
generator call: both the program and the reference read these tensors.

A layout is a nested dict/list whose leaves are shapes; ``fill`` draws
every element from one standard normal buffer and scales each leaf by its
role, found from its key path: a norm's ``scale`` is 1 + 0.1 n, a bias
0.1 n (so a program that drops either is caught), a weight n / sqrt(its
input width). The LM's layout is read off the port's own ``init_model``
on the meta device (no data), which is the format the port's ``Engine``
takes; MiniLM's is written out here, as its ``params=`` argument takes it.
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch


def minilm_layout(vocab: int, dim: int = 384, layers: int = 6,
                  d_ff: int = 1536) -> dict:
    def lin(a, b):
        return {"w": (a, b)}
    block = {"ln1": {"scale": (dim,)},
             "attn": {n: lin(dim, dim) for n in ("wq", "wk", "wv", "wo")},
             "ln2": {"scale": (dim,)},
             "mlp": {"w1": lin(dim, d_ff), "w2": lin(d_ff, dim)}}
    return {"embed": {"w": (vocab, dim)},
            "blocks": [block for _ in range(layers)],
            "final_norm": {"scale": (dim,)}}


def layout_of(tree) -> Any:
    """The shapes of a tree of (meta) tensors."""
    if isinstance(tree, dict):
        return {k: layout_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [layout_of(v) for v in tree]
    return tuple(tree.shape)


def layout_to_json(layout):
    if isinstance(layout, dict):
        return {k: layout_to_json(v) for k, v in layout.items()}
    if isinstance(layout, list):
        return [layout_to_json(v) for v in layout]
    return {"shape": list(layout)}


def layout_from_json(j):
    if isinstance(j, list):
        return [layout_from_json(v) for v in j]
    if set(j) == {"shape"} and isinstance(j["shape"], list):
        return tuple(j["shape"])
    return {k: layout_from_json(v) for k, v in j.items()}


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tuple(tree))]


def _scale_shift(path, shape, embed_std):
    """(std, mean) of the leaf at ``path``."""
    name = path[-1]
    if name == "scale":
        return 0.1, 1.0
    if name == "b":
        return 0.1, 0.0
    if "embed" in path:
        return embed_std if embed_std is not None else shape[-1] ** -0.5, 0.0
    if name in ("wuk", "wuv"):            # (rank, heads, width)
        return shape[0] ** -0.5, 0.0
    if "experts" in path:                 # (experts, in, out)
        return shape[1] ** -0.5, 0.0
    return shape[0] ** -0.5, 0.0          # (in, out)


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(layout):
    if isinstance(layout, dict):
        return {k: _skeleton(v) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_skeleton(v) for v in layout]
    return None


@torch.no_grad()
def fill(layout, seed: int, device, dtype=torch.float32,
         embed_std: float = None) -> dict:
    """Tensors of ``layout`` drawn from ``seed``: one ``randn`` into one
    buffer of ``dtype``, each leaf a view of it, scaled in place.
    ``embed_std`` overrides the embedding's 1 / sqrt(width)."""
    leaves = _leaves(layout)
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    out, at = _skeleton(layout), 0
    for path, shape in leaves:
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        std, mean = _scale_shift(path, shape, embed_std)
        t.mul_(std)
        if mean:
            t.add_(mean)
        _put(out, path, t)
        at += n
    return out


def cast(tree, dtype):
    """A copy of a tree of tensors in ``dtype`` (the control's weights)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype)
