"""Multi-head Latent Attention (DeepSeek-V2) params and projections, ported
from the JAX package's ``models/mla.py``.

The cache keeps only the compressed ``c_kv`` (rank r) and one shared
roped key head (d_rope) per token. Prefill expands them back to per-head
keys and values (``expand``; the model's ``mla_fullseq`` attends on B4,
``mla_attention`` is the reference's plain version); decode absorbs
``W_uk`` into the query and attends over the compressed cache directly
(``absorbed_q`` and ``absorbed_attention``, which the model's
``mla_decode`` and the reference's cache-dict ``mla_decode`` here share).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (_normal, apply_rope, causal_mask,
                                       dense, dense_init,
                                       gqa_scores_softmax_out, rmsnorm,
                                       rmsnorm_init)


def mla_init(gen, cfg, dtype, device):
    d = cfg.d_model
    H = cfg.n_heads
    nope, rope_d, vd, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": dense_init(gen, d, H * (nope + rope_d), dtype, device),
        "wdkv": dense_init(gen, d, r + rope_d, dtype, device),
        "ckv_norm": rmsnorm_init(r, dtype, device),
        "wuk": _normal(gen, (r, H, nope), r ** -0.5, dtype, device),
        "wuv": _normal(gen, (r, H, vd), r ** -0.5, dtype, device),
        "wo": dense_init(gen, H * vd, d, dtype, device),
    }


def _project_q(cfg, p, x):
    B, S, _ = x.shape
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, nope + rope_d)
    return q[..., :nope], q[..., nope:]


def _project_ckv(cfg, p, x, positions):
    """Returns (c_kv normalized (B,S,r), k_rope roped (B,S,1,rope_d))."""
    r = cfg.kv_lora_rank
    dkv = dense(p["wdkv"], x)
    ckv = rmsnorm(p["ckv_norm"], dkv[..., :r], cfg.norm_eps)
    krope = dkv[..., None, r:]            # single shared rope head
    return ckv, apply_rope(krope, positions, cfg.rope_theta)


def scale_of(cfg) -> float:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def expand(cfg, p, x, positions):
    """Prefill's per-head q and k (B,S,H,nope+rope) and v (B,S,H,vd), and
    the cache entries {"ckv" (B,S,r), "krope" (B,S,rope)}."""
    B, S, _ = x.shape
    H, rd = cfg.n_heads, cfg.qk_rope_head_dim
    qn, qr = _project_q(cfg, p, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv, krope = _project_ckv(cfg, p, x, positions)
    kn = torch.einsum("bsr,rhn->bshn", ckv, p["wuk"])
    v = torch.einsum("bsr,rhv->bshv", ckv, p["wuv"])
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, krope.expand(B, S, H, rd)], dim=-1)
    return q, k, v, {"ckv": ckv, "krope": krope[:, :, 0, :]}


def mla_attention(cfg, p, x, positions, *, mask_offset=0):
    """The reference's plain train/prefill path: the expanded heads under
    the causal mask at ``mask_offset``. Returns (out, {"ckv",
    "krope"})."""
    B, S, _ = x.shape
    q, k, v, kv = expand(cfg, p, x, positions)
    out = gqa_scores_softmax_out(q, k, v,
                                 causal_mask(S, S, mask_offset, x.device),
                                 scale_of(cfg))
    return dense(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.v_head_dim)), \
        kv


def absorbed_q(cfg, p, x, positions):
    """Decode's absorbed query q_c = q_nope @ W_uk^T (B,S,H,r), the roped
    q_rope (B,S,H,rope) and the token's new cache entries ckv (B,S,r) and
    krope (B,S,1,rope)."""
    qn, qr = _project_q(cfg, p, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv_new, krope_new = _project_ckv(cfg, p, x, positions)
    return torch.einsum("bshn,rhn->bshr", qn, p["wuk"]), qr, ckv_new, \
        krope_new


def absorbed_attention(q_c, qr, ckv_c, krope_c, cache_len, scale):
    """Attention over the compressed cache ckv_c (B,M,r), krope_c (B,M,dr)
    for positions [0, cache_len]: (B,S,H,r) in the cache dtype. The
    products follow the reference's dtypes: a bf16 cache is widened
    exactly against the f32 query, the probabilities and P.V are rounded
    to the cache dtype."""
    ckv, krope = ckv_c.to(q_c.dtype), krope_c.to(q_c.dtype)
    T = ckv_c.shape[1]
    logits = (torch.einsum("bshr,btr->bhst", q_c, ckv)
              + torch.einsum("bshr,btr->bhst", qr, krope)).float()
    mask = torch.arange(T, device=q_c.device) <= cache_len
    logits = (logits * scale).masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(ckv_c.dtype)
    return torch.einsum("bhst,btr->bshr", probs.float(),
                        ckv_c.float()).to(ckv_c.dtype)


def absorbed_out(cfg, p, out_c, dtype):
    """The compressed attention output (B,S,H,r) through W_uv and wo."""
    B, S = out_c.shape[:2]
    out = torch.einsum("bshr,rhv->bshv", out_c.to(dtype), p["wuv"])
    return dense(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.v_head_dim))


def mla_decode(cfg, p, x, cache, cache_len, positions):
    """The reference's cache-dict decode: ``cache`` {"ckv" (B,M,r),
    "krope" (B,M,dr)}; the token's entries written at ``cache_len``
    (clamped to the last slot) in place, roped at ``positions`` (B,1).
    Returns (out, cache). The reference's version raises (its mask has a
    rank too many); this one computes what ``models/model.py:mla_decode``
    computes."""
    q_c, qr, ckv_new, krope_new = absorbed_q(cfg, p, x, positions)
    pos = min(int(cache_len), cache["ckv"].shape[1] - 1)
    cache["ckv"][:, pos] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][:, pos] = krope_new[:, 0, 0].to(cache["krope"].dtype)
    out_c = absorbed_attention(q_c, qr, cache["ckv"], cache["krope"],
                               int(cache_len), scale_of(cfg))
    return absorbed_out(cfg, p, out_c, x.dtype), cache
