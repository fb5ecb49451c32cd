"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L, d_model 8192, 64 heads GQA kv=8, d_ff 29568, vocab 152064, M-RoPE
(t/h/w sections 16/24/24 over head_dim/2=64). The vision frontend is a STUB:
the caller passes (3, B, S) t/h/w position ids as ``mrope_positions``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
    norm_eps=1e-6,
))
