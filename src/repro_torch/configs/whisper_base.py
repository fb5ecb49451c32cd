"""Whisper-base encoder-decoder backbone [arXiv:2212.04356; unverified].

6L enc + 6L dec, d_model 512, 8 heads (MHA), d_ff 2048, vocab 51865. The conv
audio frontend is a STUB: the caller passes precomputed mel-frame
embeddings (B, encoder_seq, d_model) as ``frames``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,                # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    encoder_seq=1500,
    frontend="audio",
    gated_mlp=False,           # whisper uses plain GELU MLP
    mlp_act="gelu",
    rope_kind="none",          # learned/sinusoidal positions; we use sinusoidal
    norm_eps=1e-5,
))
