"""Qwen3-1.7B dense [hf:Qwen/Qwen3-1.7B; hf].

28L, d_model 2048, 16 heads GQA kv=8, d_ff 6144, vocab 151936, qk-norm.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    norm_eps=1e-6,
))
