"""Mamba2-130M pure SSM (SSD / state-space duality) [arXiv:2405.21060; unverified].

24L, d_model 768 (d_inner 1536, 24 SSD heads of 64), ssm_state 128, attn-free,
vocab 50280.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    rope_kind="none",
    tie_embeddings=True,
    norm_eps=1e-5,
))
