"""Distributed top-k for the mesh-sharded MIPS index (port of the JAX
package's ``distributed/topk.py``).

The precomputed-query embedding matrix is row-sharded over the "model"
axis; each shard scans its rows, takes a local top-k, makes its ids
global with the shard's row offset, then the (k-sized) candidate lists
are all-gathered and a final top-k runs over the shards x k candidates.
Traffic per query: shards * k * 8 bytes, independent of store size N.

The float local scan is the ``mips_topk`` kernel (``ops.mips_topk``: the
CUDA kernel on a card, its plain version on the CPU) unless the caller's
``local_scan(q, e, k) -> (vals, ids)`` hook replaces it, as the
reference's hook does. Quantized stores shard int8
values + per-row f32 scales (``scales=``): the local scan scores f32
queries against the int8 shard (a plain ``torch.matmul`` of the widened
values, exact, as the reference's mixed ``dot_general``), multiplies by
the row scales and masks padded rows by global row id (``n_real=``).
The ``mips_topk_int8`` kernel quantizes the query too, which is another
function. Ties keep the lower global id, as ``jax.lax.top_k`` does.

``n_real`` masks padded rows on the float path too: each shard scans only
its rows below ``n_real`` (the masked rows score -1e30 and follow in id
order, as the int8 path's do). The reference pads a float store with
-1e4 rows and no mask, so a query whose components sum below zero scores
a padded row at 1e4 times that sum and gets its id back; the port does
not copy that.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Sharded, all_gather, shard, smap
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_by_value

NEG = -1e30


def sharded_mips_topk(queries, emb, k, *, mesh, shard_axis="model",
                      local_scan=None, scales=None, n_real=None):
    """queries: (Q, D) tensor, replicated; emb: (N, D) rows over
    ``shard_axis`` (a ``Sharded`` with spec ``(shard_axis,)``, or a tensor
    sharded here).

    Returns (scores (Q, k) f32, GLOBAL row ids (Q, k) int32) on the mesh's
    first device. ``scales`` ((N,) f32, sharded like ``emb``) switches to
    the int8 shard scan; ``n_real`` masks rows with a global id at or past
    it on either path. ``local_scan(q, e, k) -> (vals, shard-local ids)``
    replaces the float path's ``ops.mips_topk``; it sees only the shard's
    rows below ``n_real``."""
    k = int(k)
    if not isinstance(emb, Sharded):
        emb = shard(emb, (shard_axis,), mesh)
    if scales is not None and not isinstance(scales, Sharded):
        scales = shard(scales, (shard_axis,), mesh)
    q = queries.float()
    scan = local_scan or ops.mips_topk

    if scales is not None:
        def local(ctx, q, e, sc):
            offset = ctx.index(shard_axis) * e.shape[0]
            s = (q @ e.float().T) * sc[None, :]
            if n_real is not None:
                rows = offset + torch.arange(e.shape[0], device=e.device)
                s = s.masked_fill(rows[None, :] >= n_real, NEG)
            v, i = topk_by_value(s, k)
            return v, i + offset

        v, i = smap(local, mesh, q, emb, scales)
    else:
        def local(ctx, q, e):
            Ml = e.shape[0]
            offset = ctx.index(shard_axis) * Ml
            n = Ml if n_real is None else max(0, min(Ml, n_real - offset))
            if n >= k:
                v, i = scan(q, e[:n], k)
            else:       # fewer real rows than k: the masked rows follow
                v = q.new_full((q.shape[0], k), NEG)
                i = torch.arange(k, dtype=torch.int32,
                                 device=q.device).repeat(q.shape[0], 1)
                if n:
                    v[:, :n], i[:, :n] = scan(q, e[:n], n)
            return v, i + offset

        v, i = smap(local, mesh, q, emb)
    # every position gathers the same candidates and would pick the same
    # answer (the reference's replicated output): pick it once
    vg = all_gather(v, shard_axis, 1).shards.flat[0]
    ig = all_gather(i, shard_axis, 1).shards.flat[0]
    vf, pos = topk_by_value(vg, k)
    return vf, torch.gather(ig, 1, pos.long())
