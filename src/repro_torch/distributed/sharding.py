"""Logical-axis sharding rules and the single-controller counterpart of
``shard_map`` (port of the JAX package's ``distributed/sharding.py``).

**Rules.** One rule engine for params / caches / batches: (path regex ->
per-dim logical axes); a logical axis resolves to mesh axes only when the
dim size divides the shard count (else that dim replicates), and a mesh
axis is used at most once per spec. A spec is a tuple with one entry per
dim: None (whole), a mesh axis name, or a tuple of names — the entries
of the reference's ``PartitionSpec``. The rules read only a mesh's
``axis_names`` and ``shape``, so ``launch/mesh.AbstractMesh`` serves
for meshes larger than the machine.

Logical axes:
  TP    -> "model"
  FSDP  -> ("pod", "data") (as available / divisible)
  BATCH -> ("pod", "data")
  SEQ   -> "model"   (KV-sequence parallel for decode caches)
  EP    -> "model"   (expert parallel)
  REP   -> replicated

**Shards.** One Python process drives every device of a mesh, as JAX's
single controller does. ``shard(t, spec, mesh)`` puts each block of ``t``
on its mesh position's device (a ``Sharded`` value: one tensor per
position, replicated over the axes the spec does not name);
``smap(fn, mesh, *args)`` calls ``fn(ctx, *local_args)`` once per
position, in row-major order, and returns the per-position results.
The collectives the reference's local functions use (``all_gather``,
``pmax``, ``psum``, ``pmean``, ``all_to_all``) take such per-position
values and are plain tensor ops across the shard list (``.to(device)``,
``cat``/``amax``/``sum``), which autograd differentiates. A local
function therefore runs in phases: local work, a collective, local work.

**Counting** (``launch/costs.py``). Under an active cost counter,
``smap`` and ``shard`` run each position as the counter's current one
(every shard of a meta mesh lies on the one ``meta`` device, so the
position cannot be read off the device), ``smap`` marks a whole tensor
it hands to a position as held there, and each collective reports its
groups to the counter's census, each member's result held at that
member, its own copies and sums not counted as compute. With no counter
active these hooks cost one test and change no value.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.launch import costs

TP, FSDP, BATCH, SEQ, EP, REP = "TP", "FSDP", "BATCH", "SEQ", "EP", "REP"


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _resolve(logical: str, dim: int, mesh) -> Optional[object]:
    """Map a logical axis to mesh axes, honoring divisibility."""
    names = mesh.axis_names
    if logical == REP:
        return None
    if logical in (TP, SEQ, EP):
        if "model" in names and dim % mesh.shape["model"] == 0:
            return "model"
        return None
    if logical in (FSDP, BATCH):
        axes = [a for a in ("pod", "data") if a in names]
        # prefer the full product, then drop axes from the left
        while axes:
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            if dim % n == 0:
                return tuple(axes) if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None
    raise ValueError(logical)


def spec_for(shape, logical_axes, mesh) -> tuple:
    if len(shape) < len(logical_axes):
        raise ValueError(f"rule {logical_axes} is longer than shape {shape}")
    # right-align the rule (leading stack dims replicate)
    pad = len(shape) - len(logical_axes)
    axes = [REP] * pad + list(logical_axes)
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        r = _resolve(ax, dim, mesh)
        # a mesh axis may appear only once in a spec
        flat = _axes(r)
        if any(f in used for f in flat):
            r = None
        used.update(flat)
        out.append(r)
    return tuple(out)


# Param rules (matched against the "/"-joined path, first match wins).
# Attention projections are head-aware (patched in param_specs): the flat
# (d, H*hd) out-dim TP-shards only when the head count divides the model
# axis; non-divisible q-heads replicate the projection, divisible q-heads
# with non-divisible kv-heads replicate k/v (Megatron-GQA).
PARAM_RULES = [
    (r"embed/w$", [TP, FSDP]),
    (r"lm_head/w$", [FSDP, TP]),
    (r"lm_head/b$", [TP]),
    (r"(attn|xattn)/wq/w$", [FSDP, TP]),
    (r"(attn|xattn)/w[kv]/w$", [FSDP, TP]),
    (r"(attn|xattn)/wq/b$", [TP]),
    (r"(attn|xattn)/w[kv]/b$", [TP]),
    (r"(attn|xattn)/wo/w$", [TP, FSDP]),
    (r"(attn|xattn)/wo/b$", [REP]),
    # MLA
    (r"attn/wdkv/w$", [FSDP, REP]),
    (r"attn/wuk$", [REP, TP, REP]),
    (r"attn/wuv$", [REP, TP, REP]),
    # MoE experts: EP on the expert dim; when E does not divide the model
    # axis (grok: 8 experts), EP resolves to None and d_ff TP-shards
    (r"moe/experts/w[13]$", [EP, FSDP, TP]),
    (r"moe/experts/w2$", [EP, TP, FSDP]),
    (r"moe/router/w$", [REP, REP]),
    (r"moe/shared/w[13]/w$", [FSDP, TP]),
    (r"moe/shared/w2/w$", [TP, FSDP]),
    # dense MLPs
    (r"mlp/w[13]/w$", [FSDP, TP]),
    (r"mlp/w2/w$", [TP, FSDP]),
    # SSM
    (r"ssm/in_proj/w$", [FSDP, TP]),
    (r"ssm/out_proj/w$", [TP, FSDP]),
    (r"ssm/conv_w$", [REP, TP]),
    (r"ssm/conv_b$", [TP]),
    (r"ssm/(A_log|dt_bias|D)$", [REP]),
    # norms and anything else small
    (r".*", [REP]),
]


def _shape_of(leaf):
    """A leaf's shape: a tensor's or array's, or the shape of a
    ``(shape, dtype)`` pair (``models/model.cache_struct``'s leaves)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def _map_with_path(fn, tree, path=()):
    """``fn("/".joined path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def heads_shardable(cfg, mesh):
    """(q_heads_ok, kv_heads_ok) on this mesh's model axis."""
    if "model" not in mesh.axis_names:
        return False, False
    n = mesh.shape["model"]
    q_ok = cfg.n_heads > 0 and cfg.n_heads % n == 0
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % n == 0
    if cfg.use_mla:  # MLA: per-head expansion weights (r,H,*) shard on H
        kv_ok = q_ok
    return q_ok, kv_ok


def param_specs(params, mesh, cfg=None):
    """A spec per leaf of a params tree (the reference's stacked layout or
    the port's per-layer lists; any leaf with a ``.shape``, meta tensors
    included). ``cfg`` enables head-aware attention sharding."""
    q_ok, kv_ok = heads_shardable(cfg, mesh) if cfg is not None \
        else (True, True)

    def one(p, leaf):
        for pat, rule in PARAM_RULES:
            if re.search(pat, p):
                rule = list(rule)
                if re.search(r"(attn|xattn)/wq/", p) and not q_ok:
                    rule = [FSDP, REP] if p.endswith("/w") else [REP]
                elif re.search(r"(attn|xattn)/w[kv]/", p) and not kv_ok:
                    rule = [FSDP, REP] if p.endswith("/w") else [REP]
                elif re.search(r"(attn|xattn)/wo/w$", p) and not q_ok:
                    rule = [REP, FSDP]
                elif re.search(r"attn/wu[kv]$", p) and not q_ok:
                    rule = [REP, REP, REP]
                return spec_for(_shape_of(leaf), rule, mesh)
        raise AssertionError(p)       # the last rule matches every path

    return _map_with_path(one, params)


# Cache rules (decode KV / SSM state). Leading dim is the layer stack.
CACHE_RULES = [
    (r"(^|/)(k|v|ak|av)$", [REP, BATCH, SEQ, REP, REP]),   # (L,B,M,Hkv,hd)
    (r"(^|/)(ckv|krope)$", [REP, BATCH, SEQ, REP]),        # (L,B,M,r)
    (r"(^|/)x[kv]$", [REP, BATCH, REP, REP, REP]),         # (L,B,Tenc,H,hd)
    (r"(^|/)h$", [REP, BATCH, TP, REP, REP]),              # (L,B,H,P,N)
    (r"(^|/)conv$", [REP, BATCH, REP, TP]),                # (L,B,W-1,C)
    (r".*", [REP]),
]

# Batch rules
BATCH_RULES = [
    (r"mrope_positions$", [REP, BATCH, REP]),              # (3,B,S)
    (r"frames$", [BATCH, REP, REP]),                       # (B,Tenc,d)
    (r".*", [BATCH, REP]),                                 # tokens/labels/pos
]


def _by_rules(rules, tree, mesh):
    def one(p, leaf):
        for pat, rule in rules:
            if re.search(pat, p):
                return spec_for(_shape_of(leaf), rule, mesh)
        raise AssertionError(p)

    return _map_with_path(one, tree)


def cache_specs(cache_struct, mesh):
    return _by_rules(CACHE_RULES, cache_struct, mesh)


def batch_specs(batch_struct, mesh):
    return _by_rules(BATCH_RULES, batch_struct, mesh)


# ---------------------------------------------------------------------------
# Placement (the reference's NamedSharding trees and device_put)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart): how
    ``place`` lays a global tensor out."""
    mesh: object
    spec: tuple


def _named(specs, mesh):
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def param_shardings(params, mesh, cfg=None):
    return _named(param_specs(params, mesh, cfg), mesh)


def cache_shardings(cache_struct, mesh):
    return _named(cache_specs(cache_struct, mesh), mesh)


def batch_shardings(batch_struct, mesh):
    return _named(batch_specs(batch_struct, mesh), mesh)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def place(tree, shardings):
    """Each tensor of ``tree`` laid out per the matching ``NamedSharding``
    of ``shardings`` (a tree of the same shape): a ``Sharded`` of copies
    on the mesh's devices (``jax.device_put``). A leaf whose sharding is
    None stays as it is."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place(v, s) for v, s in zip(tree, shardings)]
    if shardings is None:
        return tree
    mesh = shardings.mesh
    # whole onto the mesh's first device, then split there: a block of a
    # host tensor is strided, and a strided host copy is slow
    tree = tree.full() if isinstance(tree, Sharded) else \
        tree.to(mesh.devices.flat[0])
    return shard(tree, shardings.spec, mesh)


def gather(tree):
    """The global tensors of a tree of ``Sharded`` leaves (``Sharded.full``,
    on each mesh's first device); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather(v) for v in tree]
    return tree.full() if isinstance(tree, Sharded) else tree


# ---------------------------------------------------------------------------
# Shards on one controller
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _coord(mesh, pos) -> dict:
    return dict(zip(mesh.axis_names, pos))


def _index(mesh, coord, axes) -> int:
    """Row-major index of a position over ``axes`` (JAX's block order)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coord[a]
    return i


def _count(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Sharded:
    """One tensor per mesh position (``shards``, an object ndarray of the
    mesh's shape, each on its position's device). ``spec`` (one entry
    per dim) says how they tile a global tensor; it is None for values a
    local function returned, which have no global layout until
    ``with_spec`` gives them one."""

    def __init__(self, mesh, shards: np.ndarray, spec=None):
        self.mesh = mesh
        self.shards = shards
        self.spec = None if spec is None else tuple(spec)

    def with_spec(self, spec) -> "Sharded":
        return Sharded(self.mesh, self.shards, spec)

    @property
    def dtype(self):
        return self.shards.flat[0].dtype

    @property
    def shape(self) -> tuple:
        """The global shape (needs a spec)."""
        local = self.shards.flat[0].shape
        return tuple(s * _count(self.mesh, _axes(e))
                     for s, e in zip(local, self.spec))

    def __getitem__(self, i: int) -> "Sharded":
        """Index the leading (unsharded) dim: the shards' views, so an
        in-place write through the result writes the shards."""
        if self.spec is None or self.spec[0] is not None:
            raise ValueError("only an unsharded leading dim is indexed")
        out = np.empty(self.shards.shape, dtype=object)
        for pos in np.ndindex(out.shape):
            out[pos] = self.shards[pos][i]
        return Sharded(self.mesh, out, self.spec[1:])

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the mesh's first device by
        default), assembled from one replica of each block."""
        if self.spec is None:
            raise ValueError("a per-shard value has no global layout: give "
                             "it one with with_spec")
        mesh = self.mesh
        device = mesh.devices.flat[0] if device is None else device
        used = {a for e in self.spec for a in _axes(e)}
        blocks = {}
        for pos in np.ndindex(self.shards.shape):
            c = _coord(mesh, pos)
            if any(c[a] for a in mesh.axis_names if a not in used):
                continue                      # one replica of each block
            key = tuple(_index(mesh, c, _axes(e)) for e in self.spec)
            blocks[key] = self.shards[pos].to(device)
        counts = [_count(mesh, _axes(e)) for e in self.spec]

        def build(dim, prefix):
            if dim == len(counts):
                return blocks[prefix]
            parts = [build(dim + 1, prefix + (i,)) for i in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        return build(0, ())


def parts(x) -> list:
    """The local tensors of a value: a ``Sharded``'s shards (row-major over
    the mesh), else ``[x]``."""
    return list(x.shards.flat) if isinstance(x, Sharded) else [x]


def blocks(x) -> list:
    """One replica of each block of a ``Sharded`` (the shards at index 0
    of every mesh axis its spec does not name), else ``[x]``: what a sum
    over the global tensor reads once."""
    if not isinstance(x, Sharded):
        return [x]
    used = {a for e in x.spec for a in _axes(e)}
    return [x.shards[pos] for pos in np.ndindex(x.shards.shape)
            if not any(_coord(x.mesh, pos)[a] for a in x.mesh.axis_names
                       if a not in used)]


def elementwise(fn, *xs):
    """``fn`` over each position's shards of ``Sharded`` values of one
    layout (the first's spec kept), or over plain tensors."""
    if not isinstance(xs[0], Sharded):
        return fn(*xs)
    out = np.empty(xs[0].shards.shape, dtype=object)
    for pos in np.ndindex(out.shape):
        out[pos] = fn(*(x.shards[pos] for x in xs))
    return Sharded(xs[0].mesh, out, xs[0].spec)


def shard(t: torch.Tensor, spec, mesh) -> Sharded:
    """Each mesh position's block of ``t`` (dim d split over the axes of
    ``spec[d]``, a missing entry whole), copied onto its device: the
    shards never alias ``t`` or each other. Differentiable."""
    spec = tuple(spec) + (None,) * (t.dim() - len(tuple(spec)))
    sizes = []
    for d, e in enumerate(spec):
        n = _count(mesh, _axes(e))
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {e} ({n} shards)")
        sizes.append(t.shape[d] // n)
    out = np.empty(mesh.devices.shape, dtype=object)
    counter = costs.active()
    for pos in np.ndindex(out.shape):
        c = _coord(mesh, pos)
        idx = tuple(slice(_index(mesh, c, _axes(e)) * s,
                          (_index(mesh, c, _axes(e)) + 1) * s)
                    for e, s in zip(spec, sizes))
        with _at(counter, mesh, pos):
            out[pos] = t[idx].to(mesh.devices[pos], copy=True).contiguous()
    return Sharded(mesh, out, spec)


def _flat(mesh, pos) -> int:
    """A mesh position's row-major index."""
    return int(np.ravel_multi_index(pos, mesh.devices.shape))


def _at(counter, mesh, pos, quiet=False):
    """The counter's context for ``pos`` (nothing without a counter);
    ``quiet``: its ops not counted (a collective's own)."""
    return contextlib.nullcontext() if counter is None else \
        counter.at(_flat(mesh, pos), quiet)


class ShardCtx:
    """What a local function knows of its position: ``index(axis)``
    (``jax.lax.axis_index``), its ``device``."""

    def __init__(self, mesh, pos):
        self.mesh, self.pos = mesh, pos
        self.device = mesh.devices[pos]

    def index(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return _index(self.mesh, _coord(self.mesh, self.pos), axes)


def smap(fn, mesh, *args):
    """``fn(ctx, *local_args)`` at every mesh position: a ``Sharded``
    argument is passed as that position's shard, a tensor (also inside a
    dict, as a params subtree) is moved to its device (replicated),
    anything else as is. Returns the results as
    per-shard ``Sharded`` values (a tuple of them when ``fn`` returns a
    tuple)."""
    def local(a, pos, device):
        if isinstance(a, Sharded):
            return a.shards[pos]
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, dict):
            return {k: local(v, pos, device) for k, v in a.items()}
        return a

    outs = np.empty(mesh.devices.shape, dtype=object)
    counter = costs.active()
    for pos in np.ndindex(outs.shape):
        ctx = ShardCtx(mesh, pos)
        with _at(counter, mesh, pos):
            loc = [local(a, pos, ctx.device) for a in args]
            if counter is not None:     # a whole tensor is copied here
                for a in loc:
                    for _, t in costs.placed_tensors(a):
                        counter.hold(t, _flat(mesh, pos))
            outs[pos] = fn(ctx, *loc)
    first = outs.flat[0]
    if not isinstance(first, tuple):
        return Sharded(mesh, outs)
    res = []
    for j in range(len(first)):
        part = np.empty(outs.shape, dtype=object)
        for pos in np.ndindex(outs.shape):
            part[pos] = outs[pos][j]
        res.append(Sharded(mesh, part))
    return tuple(res)


def _groups(mesh, axes):
    """The positions that a collective over ``axes`` joins, each group
    ordered by its index over ``axes``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    other = [a for a in mesh.axis_names if a not in axes]
    groups = {}
    for pos in np.ndindex(mesh.devices.shape):
        c = _coord(mesh, pos)
        groups.setdefault(tuple(c[a] for a in other), []).append(
            (_index(mesh, c, axes), pos))
    return [[p for _, p in sorted(g)] for g in groups.values()]


def _reduce(x: Sharded, axes, op, kind: str) -> Sharded:
    """``op`` over each group's shards on its first member's device, the
    result copied to every member; ``kind`` names the collective to a
    cost counter."""
    mesh = x.mesh
    out = np.empty(x.shards.shape, dtype=object)
    counter = costs.active()
    for g in _groups(mesh, axes):
        d0 = mesh.devices[g[0]]
        with _at(counter, mesh, g[0], quiet=True):
            r = op([x.shards[p].to(d0) for p in g])
            for p in g:
                out[p] = r.to(mesh.devices[p])
        if counter is not None:
            counter.collective(kind, axes, [(_flat(mesh, p), out[p])
                                            for p in g])
    return Sharded(mesh, out)


def all_gather(x: Sharded, axes, dim: int) -> Sharded:
    """Every shard's blocks of the group, concatenated along ``dim`` in
    axis order (``jax.lax.all_gather(..., tiled=True)``)."""
    return _reduce(x, axes, lambda ts: torch.cat(ts, dim), "all_gather")


def pmax(x: Sharded, axes) -> Sharded:
    return _reduce(x, axes, lambda ts: torch.stack(ts).amax(0), "pmax")


def psum(x: Sharded, axes) -> Sharded:
    return _reduce(x, axes, lambda ts: torch.stack(ts).sum(0), "psum")


def pmean(x: Sharded, axes) -> Sharded:
    return _reduce(x, axes, lambda ts: torch.stack(ts).mean(0), "pmean")


def psum_replicas(x: Sharded) -> Sharded:
    """Sum the copies of each block over the mesh axes its spec does not
    name, keeping the spec: the gradient of a leaf whose copies were used
    apart (each copy's gradient holds the part of the loss that went
    through it)."""
    used = {a for e in x.spec for a in _axes(e)}
    free = tuple(a for a in x.mesh.axis_names if a not in used)
    return psum(x, free).with_spec(x.spec) if free else x


def all_to_all(x: Sharded, axes, split_dim: int = 0,
               concat_dim: int = 0) -> Sharded:
    """Shard i of a group splits its block into n chunks along
    ``split_dim`` and sends chunk j to member j, which concatenates what it
    receives along ``concat_dim`` in sender order (with both dims 0 and a
    leading dim of n, ``jax.lax.all_to_all(..., tiled=False)``)."""
    mesh = x.mesh
    out = np.empty(x.shards.shape, dtype=object)
    counter = costs.active()
    for g in _groups(mesh, axes):
        n = len(g)
        chunks = [torch.chunk(x.shards[p], n, split_dim) for p in g]
        for j, pj in enumerate(g):
            dev = mesh.devices[pj]
            with _at(counter, mesh, pj, quiet=True):
                out[pj] = torch.cat([chunks[i][j].to(dev) for i in range(n)],
                                    concat_dim)
        if counter is not None:
            counter.collective("all_to_all", axes,
                               [(_flat(mesh, p), out[p]) for p in g])
    return Sharded(mesh, out)
