"""Model/shape configuration system (a copy of the JAX package's
``configs/base.py``; the port keeps its own so it imports nothing of it).

Every architecture the port serves is a ``ModelConfig`` in its own module
under ``repro_torch.configs``; ``get_config(name)`` resolves it.
``reduced()`` produces the CPU-smoke-test variant of any config (same family
/ same code paths, tiny dims). The registered archs are the dense family's
six (``storinfer-paper-8b`` and ``storinfer-paper-1b``, the paper's own
serving model and its on-device fallback, ``llama3.2-3b``,
``starcoder2-7b``, ``qwen2.5-32b``, ``qwen3-1.7b``), the moe family's
``deepseek-v2-lite-16b`` (MLA) and ``grok-1-314b`` (GQA), the ssm
family's ``mamba2-130m``, the hybrid ``zamba2-1.2b``, the encdec
``whisper-base`` and the vlm ``qwen2-vl-72b`` (M-RoPE), and one the JAX
package does not have: ``nemotron-3-nano-30b-a3b``, a ``LayerPatternConfig``
(a stack of single-mixer blocks, Mamba-2, MoE and GQA, in a published
order).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len x global_batch).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- norm / attention details -----------------------------------------
    norm_eps: float = 1e-5
    qk_norm: bool = False  # qwen3
    attn_bias: bool = False  # qwen2.5 QKV bias
    mlp_act: str = "silu"
    gated_mlp: bool = True  # SwiGLU-style
    rope_theta: float = 1e4
    rope_kind: str = "standard"  # standard | mrope | none
    mrope_sections: Tuple[int, ...] = ()
    tie_embeddings: bool = False
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0  # width of leading dense layers in MoE stacks
    moe_capacity_factor: float = 1.25
    # --- MLA (deepseek) -----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 -> no q compression
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): shared attention block every k mamba layers -------
    hybrid_attn_every: int = 0
    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # audio frames after the (stubbed) conv frontend
    # --- modality frontend stub ----------------------------------------------
    frontend: str = "none"  # none | audio | vision
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    # --- remat / scan ----------------------------------------------------------
    remat: bool = True
    scan_layers: bool = True
    # --- what only a LayerPatternConfig sets (fields there; these are the
    # defaults every other config reads, outside its field set) -------------
    layer_pattern: ClassVar[str] = ""
    ssm_heads: ClassVar[int] = 0
    d_ff_shared: ClassVar[int] = 0
    router: ClassVar[str] = "softmax"
    routed_scale: ClassVar[float] = 1.0
    router_experts: ClassVar[int] = 0
    first_expert: ClassVar[int] = 0

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 64 (Megatron-style) so the logits
        dim shards on any model axis up to 64-way. Non-divisible vocabs
        (whisper 51865, mamba2 50280) otherwise force GSPMD to replicate the
        full (B,S,V) logits per device (observed 217 GB). Padded columns are
        masked to -inf in lm_logits."""
        return -(-self.vocab_size // 64) * 64

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner_ssm(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def n_router(self) -> int:
        """The router's width: every expert of the layer, held here or
        not."""
        return self.router_experts or self.n_experts

    @property
    def shared_width(self) -> int:
        return self.d_ff_shared or self.n_shared_experts * self.d_ff_expert

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (matches init_model within ties/bias noise)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim

        def attn_params() -> int:
            if self.use_mla:
                p = d * (self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim))
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            p += self.n_heads * hd * d
            return p

        def mlp_params(ff: int) -> int:
            return d * ff * (3 if self.gated_mlp else 2)

        def ssm_params() -> int:
            di, ns, ng = self.d_inner_ssm, self.ssm_state, self.ssm_n_groups
            p = d * (2 * di + 2 * ng * ns + self.n_ssm_heads)  # in_proj
            p += di * d  # out_proj
            p += (di + 2 * ng * ns) * self.ssm_conv
            p += 3 * self.n_ssm_heads  # A, dt_bias, D
            return p

        if self.layer_pattern:
            w = 3 if self.gated_mlp else 2
            per = {"M": ssm_params(), "*": attn_params(),
                   "E": (d * self.n_router
                         + self.n_router * (self.router == "sigmoid")
                         + self.n_experts * w * d * self.d_ff_expert
                         + w * d * self.shared_width)}
            total += sum(per[k] for k in self.layer_pattern)
        elif self.family == "dense" or self.family == "vlm":
            total += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        elif self.family == "moe":
            n_moe = self.n_layers - self.first_dense_layers
            per_moe = attn_params()
            per_moe += self.n_experts * 3 * d * self.d_ff_expert
            per_moe += self.n_shared_experts * 3 * d * self.d_ff_expert
            per_moe += d * self.n_experts  # router
            total += n_moe * per_moe
            total += self.first_dense_layers * (
                attn_params() + mlp_params(self.d_ff_dense or self.d_ff))
        elif self.family == "ssm":
            total += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            total += self.n_layers * ssm_params()
            total += attn_params() + mlp_params(self.d_ff)  # one shared block
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        n_moe = self.n_layers - self.first_dense_layers
        inactive = n_moe * (self.n_experts - self.experts_per_tok) * 3 * d * self.d_ff_expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class LayerPatternConfig(ModelConfig):
    """A stack of single-mixer blocks in the order ``layer_pattern`` gives
    (``M`` Mamba-2, ``E`` MoE, ``*`` GQA attention; Nemotron-H's
    ``hybrid_override_pattern``), with the knobs no config of the JAX
    package has. They are fields here only, so the configs that package
    registers keep its field set. ``ssm_heads`` sets the Mamba inner width
    to heads x ``ssm_head_dim`` (0: ``ssm_expand`` x d). ``d_ff_shared``
    is the shared expert's width (0: ``n_shared_experts`` x
    ``d_ff_expert``). ``router`` is ``"softmax"`` or ``"sigmoid"``
    (sigmoid scores, the top-k chosen by score plus the router's
    correction bias, the chosen scores renormalised), and
    ``routed_scale`` multiplies the routed weights. ``router_experts`` is
    the router's width when the layer holds only ``n_experts`` of them,
    experts ``first_expert`` onwards (expert parallelism's share; 0: all
    of them)."""
    layer_pattern: str = ""
    ssm_heads: int = 0
    d_ff_shared: int = 0
    router: str = "softmax"
    routed_scale: float = 1.0
    router_experts: int = 0
    first_expert: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # importing the modules populates the registry via register()
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b, grok_1_314b, llama3_2_3b, mamba2_130m,
        nemotron_3_nano_30b_a3b, qwen2_5_32b, qwen2_vl_72b, qwen3_1_7b,
        starcoder2_7b, storinfer_paper, whisper_base, zamba2_1_2b)


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants: same family & code paths, tiny dims.
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 3 if cfg.family != "hybrid" else 5),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
    )
    if cfg.family == "moe":
        # capacity factor high enough that no token drops at smoke scale —
        # capacity dropping is count-dependent and would (legitimately) break
        # prefill-vs-forward exactness checks.
        kw.update(n_experts=min(cfg.n_experts, 8), experts_per_tok=2,
                  d_ff_expert=64, d_ff_dense=128,
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  moe_capacity_factor=64.0)
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_seq=32)
    if cfg.rope_kind == "mrope":
        kw.update(mrope_sections=(4, 2, 2))
    if cfg.layer_pattern:
        # every block kind twice or more, two SSM groups, a held half of
        # the router's experts and no capacity drop
        kw.update(layer_pattern="MEM*EM*E", n_layers=8, ssm_heads=4,
                  ssm_n_groups=2, hybrid_attn_every=0, n_experts=4,
                  router_experts=8, experts_per_tok=2, d_ff_expert=32,
                  d_ff_shared=64, moe_capacity_factor=64.0)
    return dataclasses.replace(cfg, **kw)
