"""Llama-3.2-3B dense [hf:meta-llama/Llama-3.2-3B; unverified].

28L, d_model 3072, 24 heads GQA kv=8, d_ff 8192, vocab 128256, RoPE theta 5e5.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    tie_embeddings=True,
    norm_eps=1e-5,
))
