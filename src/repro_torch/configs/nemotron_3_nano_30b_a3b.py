"""NVIDIA-Nemotron-3-Nano-30B-A3B [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16].

52 single-mixer blocks in ``hybrid_override_pattern``: 23 Mamba-2 (64
heads of 64, so an inner width of 4,096; 8 groups, state 128, conv 4 with
bias, chunk 128, the gated norm over groups of 512), 23 MoE (128 routed
experts top-6 plus one shared expert of 3,712, all non-gated relu²,
routed 1,856 wide; a sigmoid router whose correction bias only chooses,
the chosen scores renormalised and scaled by 2.5) and 6 GQA attention
layers (32 query heads over 2 kv heads of 128, no bias, no rotary
embedding: the published modelling code applies none). d 2,688, vocab
131,072, untied. Each block is norm, mixer, residual.

Registered whole (all 128 experts held); a deployment's share sets
``n_experts`` to the experts held and ``first_expert`` to the first of
them, with ``router_experts`` kept at 128.
"""
from repro_torch.configs.base import LayerPatternConfig, register

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = register(LayerPatternConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid",
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    d_ff=1856,
    vocab_size=131072,
    head_dim=128,
    rope_kind="none",
    mlp_act="relu2",
    gated_mlp=False,
    # MoE
    n_experts=128,
    experts_per_tok=6,
    n_shared_experts=1,
    d_ff_expert=1856,
    d_ff_shared=3712,
    router="sigmoid",
    routed_scale=2.5,
    router_experts=128,
    # a token's assignments never exceed its expert's capacity:
    # int(T * 6 / 128 * 22) >= T (the source drops none)
    moe_capacity_factor=22.0,
    # Mamba-2
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_n_groups=8,
    ssm_state=128,
    ssm_conv=4,
    ssm_chunk=128,
    layer_pattern=PATTERN,
    norm_eps=1e-5,
))
