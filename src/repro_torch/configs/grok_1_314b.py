"""Grok-1 314B MoE [hf:xai-org/grok-1; unverified].

64L, d_model 6144, 48 heads (GQA kv=8), 8 experts top-2, expert d_ff 32768,
vocab 131072. Experts (8) are not divisible by the 16-way model axis, so the
sharding rule uses FSDP expert weights + TP d_ff (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_tok=2,
    n_shared_experts=0,
    d_ff_expert=32768,
    first_dense_layers=0,
    rope_theta=1e4,
    norm_eps=1e-5,
))
