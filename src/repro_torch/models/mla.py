"""Multi-head Latent Attention (DeepSeek-V2) params and projections, ported
from the JAX package's ``models/mla.py``.

The cache keeps only the compressed ``c_kv`` (rank r) and one shared
roped key head (d_rope) per token. Prefill expands them back to per-head
keys and values (``models/model.py:mla_fullseq``, on B4); decode absorbs
``W_uk`` into the query and attends over the compressed cache directly
(``models/model.py:mla_decode``).
"""
from __future__ import annotations

from repro_torch.models.layers import (_normal, apply_rope, dense,
                                       dense_init, rmsnorm, rmsnorm_init)


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
