"""The paper's own serving model: LLaMA-3.1-8B-class dense LM.

StorInfer generates and serves with LLaMA-3.1-8B (fallback: LLaMA-3.2-1B on
device). This config is the 8B backbone used by the paper-reproduction
benchmarks; `storinfer-paper-1b` is the on-device fallback.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="storinfer-paper-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    norm_eps=1e-5,
))

FALLBACK_1B = register(ModelConfig(
    name="storinfer-paper-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=5e5,
    tie_embeddings=True,
    norm_eps=1e-5,
))
