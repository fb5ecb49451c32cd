"""KV-sequence-sharded decode attention (flash-decoding over a mesh; port of
the JAX package's ``distributed/decode_attn.py``).

The decode cache is split along its SEQUENCE dim over ``seq_axis`` (and
its batch rows over ``batch_axes`` where B divides). Each shard:

  1. writes the new entry iff the global write position lands in it (a
     write past the end lands on the last slot, in the last shard, as the
     one-device decode clamps it),
  2. computes partial attention (o, m, l) over its slice under the
     inclusive ``pos <= cache_len`` mask,
  3. combines with the max-rescale trick: one pmax + two psums.

The caches are ``Sharded`` values written in place (the port's decode
writes into the cache it is given); a tensor cache is sharded on entry.
With ``live``, a dead slot's new entry is attended and then put back, as
the one-device decode does. The local partial is plain PyTorch, as the
reference's is: the ``decode_attention`` kernel fuses its split merge and
returns no (m, l).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (Sharded, _axes, pmax, psum,
                                              shard, smap)

NEG_INF = -1e30


def _batch_spec(mesh, batch_axes, B):
    """The batch dim's spec entry: the batch axes the mesh has, or None
    when B does not divide over them."""
    b_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    n = 1
    for a in b_axes:
        n *= mesh.shape[a]
    if not b_axes or B % n:
        return None
    return b_axes if len(b_axes) > 1 else b_axes[0]


def _split(t, bspec, mesh):
    """A per-batch-row input: split over the batch axes, or replicated."""
    if t is None or bspec is None:
        return t
    return shard(t, (bspec,), mesh)


def _placed(c, spec, mesh) -> Sharded:
    """The cache leaf laid out by ``spec``: a tensor is sharded; a
    ``Sharded`` must already have that layout (it is written in place)."""
    if not isinstance(c, Sharded):
        return shard(c, spec, mesh)

    def split(entries):      # an axis of size 1 splits nothing
        return [tuple(a for a in _axes(e) if mesh.shape[a] > 1)
                for e in entries]
    if split(c.spec) != split(tuple(spec) + (None,) * (len(c.spec) -
                                                       len(spec))):
        raise ValueError(f"a seq-sharded cache leaf laid out as {c.spec}, "
                         f"this decode needs {tuple(spec)}")
    return c


def _write(c, loc, new, live):
    """Write ``new`` (b, ...) at local position ``loc`` of shard ``c``;
    return what dead slots must get back (None when all are live)."""
    old = None if live is None else c[:, loc].clone()
    c[:, loc] = new.to(c.dtype)
    return old


def _restore(c, loc, old, live):
    if live is not None:
        keep = live.view((-1,) + (1,) * (old.dim() - 1))
        c[:, loc] = torch.where(keep, c[:, loc], old)


def _partials(ctx, seq_axis, pos, cache_len, caches, news, live, attend):
    """One shard's step: write the new entries where ``pos`` lands,
    ``attend(valid)`` -> (o, m, l) over the slice, put dead slots back."""
    Ml = caches[0].shape[1]
    start = ctx.index(seq_axis) * Ml
    loc = pos - start
    mine = 0 <= loc < Ml
    olds = [_write(c, loc, n, live) for c, n in zip(caches, news)] \
        if mine else []
    valid = start + torch.arange(Ml, device=ctx.device) <= cache_len
    o, m, l = attend(valid)
    for c, old in zip(caches, olds):
        _restore(c, loc, old, live)
    return o, m, l


def _combine(o, m, l, seq_axis, mesh):
    """(o, m, l) partial flash stats -> the combined output per shard."""
    m_g = pmax(m, seq_axis)

    def rescale(ctx, o, m, l, m_g):
        corr = torch.exp(m - m_g)
        return o * corr[..., None].to(o.dtype), l * corr

    oc, lc = smap(rescale, mesh, o, m, l, m_g)
    return smap(lambda ctx, o, l: o / torch.clamp(l, min=1e-30)[
        ..., None].to(o.dtype), mesh, psum(oc, seq_axis), psum(lc, seq_axis))


def gqa_decode_seq_sharded(q, k_new, v_new, kc, vc, cache_len: int, *,
                           mesh, seq_axis="model", batch_axes=("data",),
                           live=None):
    """One-token GQA decode over a seq-sharded cache.

    q      : (B, 1, Hq, D)   — replicated over ``seq_axis``
    k_new  : (B, 1, Hkv, D)  — this step's key (pre-roped)
    v_new  : (B, 1, Hkv, D)
    kc, vc : (B, M, Hkv, D)  — M sharded over ``seq_axis``
    cache_len: the global write/attend position

    Returns (out (B,1,Hq*D) on q's device, kc, vc)."""
    B, _, Hq, D = q.shape
    bspec = _batch_spec(mesh, batch_axes, B)
    kc = _placed(kc, (bspec, seq_axis), mesh)
    vc = _placed(vc, (bspec, seq_axis), mesh)
    Hkv = kc.shape[2]
    G = Hq // Hkv
    pos = min(cache_len, kc.shape[1] - 1)
    scale = D ** -0.5

    def local(ctx, q, k_new, v_new, kc, vc, live):
        def attend(valid):
            qg = q.reshape(q.shape[0], Hkv, G, D)
            s = torch.einsum("bkgd,btkd->bkgt", qg,
                             kc.to(q.dtype)).float() * scale
            s = s.masked_fill(~valid, NEG_INF)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            o = torch.einsum("bkgt,btkv->bkgv", p.to(vc.dtype), vc)
            return o, m, p.sum(-1)
        return _partials(ctx, seq_axis, pos, cache_len, (kc, vc),
                         (k_new[:, 0], v_new[:, 0]), live, attend)

    o, m, l = smap(local, mesh, _split(q, bspec, mesh),
                   _split(k_new, bspec, mesh), _split(v_new, bspec, mesh),
                   kc, vc, _split(live, bspec, mesh))
    out = _combine(o, m, l, seq_axis, mesh)                 # (b,Hkv,G,D)
    out = out.with_spec((bspec,)).full(q.device)
    return out.reshape(B, 1, Hq * D), kc, vc


def mla_decode_seq_sharded(q_c, q_r, ckv_new, krope_new, ckv_c, krope_c,
                           cache_len: int, scale, *, mesh, seq_axis="model",
                           batch_axes=("data",), live=None):
    """Absorbed-MLA decode over a seq-sharded compressed cache.

    q_c: (B,1,H,r); q_r: (B,1,H,dr); ckv_new: (B,1,r); krope_new: (B,1,dr);
    ckv_c: (B,M,r); krope_c: (B,M,dr). Returns (out_c (B,1,H,r) on q_c's
    device, ckv_c, krope_c). The products follow the one-device
    ``mla_decode``'s dtypes (P.V in f32, rounded to the cache dtype)."""
    B = q_c.shape[0]
    bspec = _batch_spec(mesh, batch_axes, B)
    ckv_c = _placed(ckv_c, (bspec, seq_axis), mesh)
    krope_c = _placed(krope_c, (bspec, seq_axis), mesh)
    pos = min(cache_len, ckv_c.shape[1] - 1)

    def local(ctx, q_c, q_r, ckv_new, krope_new, ckv_c, krope_c, live):
        def attend(valid):
            s = (torch.einsum("bshr,btr->bhst", q_c, ckv_c.to(q_c.dtype))
                 + torch.einsum("bshr,btr->bhst", q_r,
                                krope_c.to(q_r.dtype))).float() * scale
            s = s.masked_fill(~valid, NEG_INF)                # (b,H,1,Ml)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            o = torch.einsum("bhst,btr->bhsr", p.to(ckv_c.dtype).float(),
                             ckv_c.float()).to(ckv_c.dtype)
            return o, m, p.sum(-1)
        return _partials(ctx, seq_axis, pos, cache_len, (ckv_c, krope_c),
                         (ckv_new[:, 0], krope_new[:, 0]), live, attend)

    o, m, l = smap(local, mesh, _split(q_c, bspec, mesh),
                   _split(q_r, bspec, mesh), _split(ckv_new, bspec, mesh),
                   _split(krope_new, bspec, mesh), ckv_c, krope_c,
                   _split(live, bspec, mesh))
    out = _combine(o, m, l, seq_axis, mesh)                 # (b,H,1,r)
    out = out.with_spec((bspec,)).full(q_c.device)
    return out.transpose(1, 2), ckv_c, krope_c              # (B,1,H,r)
