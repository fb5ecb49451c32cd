"""Zamba2-1.2B hybrid (Mamba2 backbone + shared attention) [arXiv:2411.15242; hf].

38 Mamba2 layers, d_model 2048, ssm_state 64; a weight-shared transformer block
(32 heads MHA, d_ff 8192) is invoked every 6 mamba layers (simplified from
Zamba2's dual shared blocks + per-use LoRA — DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_attn_every=6,
    rope_theta=1e4,
    norm_eps=1e-5,
))
