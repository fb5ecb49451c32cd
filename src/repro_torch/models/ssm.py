"""Mamba2 (SSD, state-space duality) block: chunked scan for a full
sequence and the recurrent single-token step, ported from the JAX
package's ``models/ssm.py``.

It follows the ssd_minimal_discrete formulation of arXiv:2405.21060, with
the inter-chunk recurrence as a loop over chunks. The decode state is
``h`` (B, H, P, N), kept in f32 in every cache, and ``conv`` (B, W-1, C),
the last W-1 inputs of the causal convolution before it is applied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_normal, dense, dense_init,
                                       gated_rmsnorm, rmsnorm_init)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def ssm_init(gen, cfg, dtype, device):
    d = cfg.d_model
    di = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    G, N, W = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv
    conv_ch = di + 2 * G * N
    f32 = torch.float32
    return {
        # in_proj -> [z (di), xBC (di + 2GN), dt (H)]
        "in_proj": dense_init(gen, d, 2 * di + 2 * G * N + H, dtype, device),
        "conv_w": _normal(gen, (W, conv_ch), W ** -0.5, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),  # A = -1
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "norm": rmsnorm_init(di, dtype, device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _split_in_proj(cfg, zxbcdt):
    di = cfg.d_inner_ssm
    GN2 = 2 * cfg.ssm_n_groups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + GN2],
            zxbcdt[..., 2 * di + GN2:])


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(p, xBC):
    """Depthwise causal conv1d over (B, S, C): the sum over the window of
    shifted slices, in the reference's order (W is 4)."""
    W = p["conv_w"].shape[0]
    S = xBC.shape[1]
    x = F.pad(xBC, (0, 0, W - 1, 0))
    out = x[:, 0:S, :] * p["conv_w"][0]
    for i in range(1, W):
        out = out + x[:, i:i + S, :] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} x[k] and
    -inf above the diagonal (0 after exp)."""
    c = torch.cumsum(x, dim=-1)
    L = c[..., :, None] - c[..., None, :]
    Q = x.shape[-1]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return L.masked_fill(~keep, float("-inf"))


def ssd_chunked(xdt, dA, Bm, Cm, chunk, h0=None):
    """SSD over a full sequence.

    xdt: (B, S, H, P)  — inputs pre-multiplied by dt
    dA : (B, S, H)     — log decay per step (dt * A, A negative)
    Bm, Cm: (B, S, G, N) with G | H (broadcast groups)
    Returns (y (B,S,H,P) in xdt's dtype, h_final (B,H,P,N) f32). ``S``
    must be a multiple of ``chunk``, as in the reference.
    """
    B, S, H, P = xdt.shape
    G = Bm.shape[2]
    rep = H // G
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {chunk}")
    f32 = torch.float32

    def c(t):  # (B, S, ...) -> (B, nc, chunk, ...)
        return t.reshape((B, nc, chunk) + tuple(t.shape[2:]))

    x_, a_, b_, c_ = c(xdt), c(dA), c(Bm), c(Cm)
    b_ = b_.repeat_interleave(rep, dim=3)              # (B,nc,Q,H,N)
    c_ = c_.repeat_interleave(rep, dim=3)
    a_ = a_.movedim(-1, 2)                             # (B,nc,H,Q)
    a_cum = torch.cumsum(a_, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(a_.to(f32)))                 # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", c_, b_).to(f32)
    y_diag = torch.einsum("bchqs,bchqs,bcshp->bcqhp", scores, L,
                          x_.to(f32))

    # 2. per-chunk final states
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum).to(f32)
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", b_.to(f32),
                          decay_to_end, x_.to(f32))

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cum[..., -1].to(f32))    # (B,nc,H)
    h = torch.zeros((B, H, P, Bm.shape[3]), dtype=f32, device=xdt.device) \
        if h0 is None else h0
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prev, dim=1)                # (B,nc,H,P,N)

    # 4. contribution of the entering state to each position
    state_decay = torch.exp(a_cum).to(f32)             # (B,nc,H,Q)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", c_.to(f32), h_prev,
                         state_decay)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(xdt.dtype), h


def ssm_forward(cfg, p, x, state=None, chunk=None):
    """Full-sequence (prefill) Mamba2 block. Returns (y, (h, conv_state)):
    h (B,H,P,N) f32, conv_state the last W-1 pre-conv inputs (B,W-1,C),
    left-padded with zeros when S < W-1."""
    B, S, _ = x.shape
    chunk = chunk or cfg.ssm_chunk
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    di = cfg.d_inner_ssm
    z, xBC_raw, dt = _split_in_proj(cfg, dense(p["in_proj"], x))
    xBC = causal_conv(p, xBC_raw)
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N)
    dt = _softplus(dt.float() + p["dt_bias"])                      # (B,S,H)
    A = -torch.exp(p["A_log"])                                     # (H,)
    dA = dt * A
    xdt = xs * dt[..., None].to(xs.dtype)
    y, h = ssd_chunked(xdt, dA, Bm, Cm, min(chunk, S), h0=state)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = gated_rmsnorm(p["norm"], y.reshape(B, S, di), z, cfg.norm_eps,
                      cfg.ssm_n_groups)
    W = cfg.ssm_conv
    pad = F.pad(xBC_raw, (0, 0, max(W - 1 - S, 0), 0))
    return dense(p["out_proj"], y), (h, pad[:, -(W - 1):, :])


def ssm_decode(cfg, p, x, state, conv_state):
    """Single-token decode. state (B,H,P,N) f32; conv_state (B,W-1,C) in
    the cache's dtype (widened before use, as the reference's promotion
    does). Returns (y, (new h f32, new conv_state in x's dtype))."""
    B = x.shape[0]
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    di = cfg.d_inner_ssm
    z, xBC, dt = _split_in_proj(cfg, dense(p["in_proj"], x))
    window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)  # (B, W, C)
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv)[:, None, :]
    xs = xBC[..., :di].reshape(B, H, P)
    rep = H // G
    Bm = xBC[..., di:di + G * N].reshape(B, G, N).repeat_interleave(rep, 1)
    Cm = xBC[..., di + G * N:].reshape(B, G, N).repeat_interleave(rep, 1)
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])               # (B,H)
    dec = torch.exp(dt * -torch.exp(p["A_log"]))                  # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bm.float(), xs.float())
    h = state * dec[..., None, None] + upd                        # (B,H,P,N)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), h)
    y = y.to(xs.dtype) + xs * p["D"][None, :, None].to(xs.dtype)
    y = gated_rmsnorm(p["norm"], y.reshape(B, 1, di), z, cfg.norm_eps,
                      cfg.ssm_n_groups)
    return dense(p["out_proj"], y), (h, window[:, 1:, :])
