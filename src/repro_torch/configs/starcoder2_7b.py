"""StarCoder2-7B dense [arXiv:2402.19173; hf].

32L, d_model 4608, 36 heads GQA kv=4, d_ff 18432, vocab 49152, RoPE, plain
GELU MLP (non-gated, like the released model), attention bias on.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    gated_mlp=False,
    mlp_act="gelu",
    attn_bias=True,
    rope_theta=1e5,
    norm_eps=1e-5,
))
