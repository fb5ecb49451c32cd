"""Blockwise (flash-style) attention in plain PyTorch with a hand-written
backward, ported from the JAX package's ``models/blockwise.py``.

Numerically the full softmax attention, without the (S, T) score matrix:
the forward walks KV tiles carrying the running (out, max, sum) triple of
each query tile, and the backward is the flash backward from the saved
log-sum-exp (it recomputes each tile's probabilities; nothing of size
S x T is kept). This is the attention training runs (``RunCfg(
attn_impl="blockwise")``, the reference's default): the ``flash_attention``
kernel has no backward, in either package.

Both functions are ``torch.autograd.Function``s over the model's layout:

* ``blockwise_gqa`` — q (B,S,Hq,D), k and v (B,T,Hkv,D[v]) -> (B,S,Hq,Dv);
  causal or not, queries at global position ``mask_offset + i``,
  ``q_block``/``kv_block`` tiles. ``schedule="rect"`` visits every tile,
  as the reference does; ``"tri"`` (causal only) skips the tiles above the
  diagonal in the forward and in the backward, where their probabilities
  are exactly 0.
* ``blockwise_mla`` — MLA's absorbed attention over the compressed cache:
  logits ``q_c . ckv[t] + q_r . krope[t]``, values the ``ckv`` rows, the
  output expanded through ``v_up`` at the end (outside the Function, so
  plain autograd takes that product). The reference differentiates it
  through its scan; here it has the same flash backward as
  ``blockwise_gqa``.

Every step follows the reference's dtypes: scores in the inputs' dtype
widened to f32, the running max and sum f32, probabilities cast to the
values' dtype before P.V, the running output in the values' dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class _Grid:
    """The tile grid of one call."""
    causal: bool
    scale: float
    mask_offset: int
    S: int                       # real (unpadded) query length
    T: int                       # real (unpadded) key length
    qb: int
    kb: int
    tri: bool

    @property
    def nq(self) -> int:
        return -(-self.S // self.qb)

    @property
    def nk(self) -> int:
        return -(-self.T // self.kb)

    def visible(self, qi: int) -> int:
        """KV tiles query tile ``qi`` visits: all of them, or under the
        ``tri`` schedule those that overlap [0, (qi+1) qb + offset)."""
        if not self.tri:
            return self.nk
        return min(self.nk, -(-((qi + 1) * self.qb + self.mask_offset)
                              // self.kb))

    def mask(self, qi: int, kj: int, device) -> torch.Tensor:
        """(qb, kb) bool: key inside T and, if causal, at or before the
        query's global position."""
        kp = kj * self.kb + torch.arange(self.kb, device=device)
        keep = (kp < self.T)[None, :]
        if self.causal:
            qp = self.mask_offset + qi * self.qb + \
                torch.arange(self.qb, device=device)
            keep = keep & (kp[None, :] <= qp[:, None])
        return keep


def _grid(S, T, D, causal, mask_offset, q_block, kv_block, schedule,
          scale=None):
    if schedule not in ("rect", "tri"):
        raise ValueError(f"schedule must be 'rect' or 'tri', got "
                         f"{schedule!r}")
    return _Grid(causal=causal, scale=D ** -0.5 if scale is None else scale,
                 mask_offset=int(mask_offset), S=S, T=T,
                 qb=min(q_block, S), kb=min(kv_block, T),
                 tri=schedule == "tri" and causal)


def _pad_seq(t, n):
    """Zero-pad dim 1 of ``t`` to ``n``."""
    if t.shape[1] == n:
        return t
    pad = [0, 0] * (t.dim() - 2) + [0, n - t.shape[1]]
    return F.pad(t, pad)


def _online(o, m, l, s, vt, eq):
    """One step of the running softmax: s (..., qb, kb) f32 masked scores,
    vt the values tile, ``eq`` the P.V einsum. Returns (o, m, l)."""
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(-1)
    pv = torch.einsum(eq, p.to(vt.dtype), vt)
    return o * alpha[..., None].to(o.dtype) + pv, m_new, l


def _finish(o, m, l):
    out = o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _gqa_tiles(g: _Grid, q, k, v):
    """q (B,S,Hq,D), k/v (B,T,Hkv,D[v]) -> lists of tiles: q (B,qb,Hkv,G,D),
    k (B,kb,Hkv,D), v (B,kb,Hkv,Dv)."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    qp = _pad_seq(q, g.nq * g.qb).reshape(B, g.nq, g.qb, Hkv, Hq // Hkv, D)
    kp = _pad_seq(k, g.nk * g.kb).reshape(B, g.nk, g.kb, Hkv, D)
    vp = _pad_seq(v, g.nk * g.kb).reshape(B, g.nk, g.kb, Hkv, v.shape[-1])
    return qp.unbind(1), kp.unbind(1), vp.unbind(1)


def _gqa_scores(g, qt, kt, qi, kj):
    s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt).float() * g.scale
    return s.masked_fill(~g.mask(qi, kj, qt.device), NEG_INF)


class _BlockwiseGQA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, g):
        qg, kg, vg = _gqa_tiles(g, q, k, v)
        B, qb, Hkv, G, _ = qg[0].shape
        Dv = v.shape[-1]
        outs, lses = [], []
        for qi, qt in enumerate(qg):
            o = torch.zeros((B, Hkv, G, qb, Dv), dtype=v.dtype,
                            device=v.device)
            m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32,
                           device=v.device)
            l = torch.zeros_like(m)
            for kj in range(g.visible(qi)):
                o, m, l = _online(o, m, l, _gqa_scores(g, qt, kg[kj], qi, kj),
                                  vg[kj], "bhgqk,bkhv->bhgqv")
            out, lse = _finish(o, m, l)
            outs.append(out.permute(0, 3, 1, 2, 4))          # (B,qb,Hkv,G,Dv)
            lses.append(lse)
        out = torch.stack(outs, 1)                           # (B,nq,qb,...)
        ctx.save_for_backward(q, k, v, out, torch.stack(lses))
        ctx.grid = g
        Hq = q.shape[2]
        return out.reshape(B, g.nq * qb, Hq, Dv)[:, :g.S]

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        g = ctx.grid
        qg, kg, vg = _gqa_tiles(g, q, k, v)
        B, qb, Hkv, G, D = qg[0].shape
        Dv = v.shape[-1]
        dog = _pad_seq(dout, g.nq * qb).reshape(B, g.nq, qb, Hkv, G, Dv)
        delta = torch.einsum("bnqhgv,bnqhgv->nbhgq", dog.float(),
                             out.float())
        dt = q.dtype
        dq = [torch.zeros_like(t) for t in qg]
        dk = [torch.zeros_like(t) for t in kg]
        dv = [torch.zeros_like(t) for t in vg]
        for qi, qt in enumerate(qg):
            do = dog[:, qi]
            for kj in range(g.visible(qi)):
                s = _gqa_scores(g, qt, kg[kj], qi, kj)
                p = torch.exp(s - lse[qi][..., None])       # (B,Hkv,G,qb,kb)
                dp = torch.einsum("bqhgv,bkhv->bhgqk", do, vg[kj]).float()
                ds = (p * (dp - delta[qi][..., None]) * g.scale).to(dt)
                dq[qi] = dq[qi] + torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                               kg[kj])
                dk[kj] = dk[kj] + torch.einsum("bhgqk,bqhgd->bkhd", ds, qt)
                dv[kj] = dv[kj] + torch.einsum("bhgqk,bqhgv->bkhv",
                                               p.to(dt), do)
        S, T = g.S, g.T
        dq = torch.stack(dq, 1).reshape(B, g.nq * qb, Hkv * G, D)[:, :S]
        dk = torch.stack(dk, 1).reshape(B, g.nk * g.kb, Hkv, D)[:, :T]
        dv = torch.stack(dv, 1).reshape(B, g.nk * g.kb, Hkv, Dv)[:, :T]
        return dq, dk, dv, None


def blockwise_gqa(q, k, v, *, causal=True, mask_offset=0, q_block=512,
                  kv_block=1024, schedule="rect"):
    """q (B,S,Hq,D), k and v (B,T,Hkv,D[v]) -> (B,S,Hq,Dv) in v's dtype.

    A query at global position ``mask_offset + i`` attends keys
    j <= mask_offset + i when ``causal``, every key otherwise."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape[:3] != k.shape[:3] or Hq % Hkv:
        raise ValueError(f"blockwise_gqa: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    g = _grid(S, T, D, causal, mask_offset, q_block, kv_block, schedule)
    return _BlockwiseGQA.apply(q, k, v, g)


# ---------------------------------------------------------------------------
# Absorbed MLA over the compressed cache
# ---------------------------------------------------------------------------


def _mla_tiles(g: _Grid, q_c, q_r, ckv, krope):
    B, _, H, r = q_c.shape
    dr = q_r.shape[-1]
    n, m = g.nq * g.qb, g.nk * g.kb
    return (_pad_seq(q_c, n).reshape(B, g.nq, g.qb, H, r).unbind(1),
            _pad_seq(q_r, n).reshape(B, g.nq, g.qb, H, dr).unbind(1),
            _pad_seq(ckv, m).reshape(B, g.nk, g.kb, r).unbind(1),
            _pad_seq(krope, m).reshape(B, g.nk, g.kb, dr).unbind(1))


def _mla_scores(g, qc, qr, cc, kr, qi, kj):
    s = (torch.einsum("bqhr,bkr->bhqk", qc, cc)
         + torch.einsum("bqhr,bkr->bhqk", qr, kr)).float() * g.scale
    return s.masked_fill(~g.mask(qi, kj, qc.device), NEG_INF)


class _BlockwiseMLA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q_c, q_r, ckv, krope, g):
        qcg, qrg, cg, kg = _mla_tiles(g, q_c, q_r, ckv, krope)
        B, qb, H, r = qcg[0].shape
        outs, lses = [], []
        for qi in range(g.nq):
            o = torch.zeros((B, H, qb, r), dtype=ckv.dtype, device=ckv.device)
            m = torch.full((B, H, qb), NEG_INF, dtype=torch.float32,
                           device=ckv.device)
            l = torch.zeros_like(m)
            for kj in range(g.visible(qi)):
                s = _mla_scores(g, qcg[qi], qrg[qi], cg[kj], kg[kj], qi, kj)
                o, m, l = _online(o, m, l, s, cg[kj], "bhqk,bkr->bhqr")
            out, lse = _finish(o, m, l)
            outs.append(out.transpose(1, 2))                 # (B,qb,H,r)
            lses.append(lse)
        out = torch.stack(outs, 1)                           # (B,nq,qb,H,r)
        ctx.save_for_backward(q_c, q_r, ckv, krope, out, torch.stack(lses))
        ctx.grid = g
        return out.reshape(B, g.nq * qb, H, r)[:, :g.S]

    @staticmethod
    def backward(ctx, dout):
        q_c, q_r, ckv, krope, out, lse = ctx.saved_tensors
        g = ctx.grid
        qcg, qrg, cg, kg = _mla_tiles(g, q_c, q_r, ckv, krope)
        B, qb, H, r = qcg[0].shape
        dog = _pad_seq(dout, g.nq * qb).reshape(B, g.nq, qb, H, r)
        delta = torch.einsum("bnqhr,bnqhr->nbhq", dog.float(), out.float())
        dt = q_c.dtype
        dqc = [torch.zeros_like(t) for t in qcg]
        dqr = [torch.zeros_like(t) for t in qrg]
        dc = [torch.zeros_like(t) for t in cg]
        dkr = [torch.zeros_like(t) for t in kg]
        for qi in range(g.nq):
            do = dog[:, qi]
            for kj in range(g.visible(qi)):
                s = _mla_scores(g, qcg[qi], qrg[qi], cg[kj], kg[kj], qi, kj)
                p = torch.exp(s - lse[qi][..., None])        # (B,H,qb,kb)
                dp = torch.einsum("bqhr,bkr->bhqk", do, cg[kj]).float()
                ds = (p * (dp - delta[qi][..., None]) * g.scale).to(dt)
                dqc[qi] = dqc[qi] + torch.einsum("bhqk,bkr->bqhr", ds, cg[kj])
                dqr[qi] = dqr[qi] + torch.einsum("bhqk,bkr->bqhr", ds, kg[kj])
                dc[kj] = dc[kj] + torch.einsum("bhqk,bqhr->bkr", ds, qcg[qi]) \
                    + torch.einsum("bhqk,bqhr->bkr", p.to(dt), do)
                dkr[kj] = dkr[kj] + torch.einsum("bhqk,bqhr->bkr", ds,
                                                 qrg[qi])
        S, T = g.S, g.T

        def cat(ts, n):
            x = torch.stack(ts, 1)
            return x.reshape((B, n) + tuple(x.shape[3:]))

        return (cat(dqc, g.nq * qb)[:, :S], cat(dqr, g.nq * qb)[:, :S],
                cat(dc, g.nk * g.kb)[:, :T], cat(dkr, g.nk * g.kb)[:, :T],
                None)


def blockwise_mla(q_c, q_r, ckv, krope, *, v_up, scale, causal=True,
                  mask_offset=0, q_block=512, kv_block=1024):
    """q_c (B,S,H,r) absorbed queries; q_r (B,S,H,dr); ckv (B,T,r);
    krope (B,T,dr); v_up (r,H,Dv). Returns (B,S,H,Dv)."""
    S, r = q_c.shape[1], q_c.shape[-1]
    T = ckv.shape[1]
    g = _grid(S, T, r, causal, mask_offset, q_block, kv_block, "rect",
              scale=scale)
    o_c = _BlockwiseMLA.apply(q_c, q_r, ckv, krope, g)
    return torch.einsum("bshr,rhv->bshv", o_c, v_up)
