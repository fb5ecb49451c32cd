"""Qwen2.5-32B dense [hf:Qwen/Qwen2.5-32B; hf].

64L, d_model 5120, 40 heads GQA kv=8, d_ff 27648, vocab 152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1e6,
    norm_eps=1e-6,
))
