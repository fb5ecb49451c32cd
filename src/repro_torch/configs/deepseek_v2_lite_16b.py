"""DeepSeek-V2-Lite (15.7B total / 2.4B active) [arXiv:2405.04434; hf].

MLA attention (kv_lora_rank=512, decoupled RoPE 64), 64 routed experts top-6 +
2 shared experts, first layer dense (d_ff 10944). The assignment line lists both
"64e top-6" and "2 shared+160 routed"; we follow the HF V2-Lite checkpoint
config (64 routed + 2 shared, top-6) — see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # MoE expert intermediate size
    vocab_size=102400,
    # MLA
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,             # V2-Lite has no q compression
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,              # qk_nope + qk_rope
    # MoE
    n_experts=64,
    experts_per_tok=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    first_dense_layers=1,
    d_ff_dense=10944,
    rope_theta=1e4,
    norm_eps=1e-6,
))
