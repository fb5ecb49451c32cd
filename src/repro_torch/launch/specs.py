"""The training part of the JAX package's ``launch/specs.py``: the
per-arch defaults of a train cell, ``make_runcfg`` (the layout knobs of a
shape on a mesh), the train branch of its ``build_cell`` (sequence
parallelism, the SSD tile and the accumulation scaled to the mesh) and
the batch's shapes and dtypes. ``build_cell`` and ``CellPlan`` (lowering
plans for the dry run) are not here: they belong to the dry-run tooling.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed import sharding as Sh
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype

# Per-arch gradient-accumulation defaults for train_4k (1M-token global
# batch), the reference's: calibrated for its 512-chip multi-pod mesh.
TRAIN_ACCUM = {
    "qwen2-vl-72b": 8, "grok-1-314b": 8, "qwen2.5-32b": 8,
    "starcoder2-7b": 4, "deepseek-v2-lite-16b": 2, "llama3.2-3b": 2,
    "qwen3-1.7b": 2, "zamba2-1.2b": 8, "whisper-base": 1, "mamba2-130m": 1,
    "storinfer-paper-8b": 2, "storinfer-paper-1b": 1,
}

# Megatron-style sequence parallelism on the residual stream for train
TRAIN_SP = {"starcoder2-7b", "qwen2.5-32b", "qwen2-vl-72b"}
# pinning SSD internals to batch-only sharding: none (the reference found
# it slower under GSPMD; the port's SSD is batch-only regardless)
PREFILL_PIN_SSM: set = set()

# the SSD tile at train and prefill time (exact at any size)
TRAIN_SSM_CHUNK = {"zamba2-1.2b": 128}
PREFILL_SSM_CHUNK = {"zamba2-1.2b": 64}

FULL_ATTN_FAMILIES = ("dense", "moe", "vlm", "encdec")


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip(full-attn): 500k decode needs sub-quadratic attention"
    return None


def make_runcfg(cfg, shape, mesh, **overrides) -> M.RunCfg:
    """The reference's choice of knobs for ``shape`` on ``mesh`` (an
    ``AbstractMesh`` serves: only its axis names and sizes are read)."""
    kind = shape.kind
    moe_impl = "scatter"
    if cfg.family == "moe":
        ep_ok = (mesh is not None and "model" in mesh.axis_names
                 and cfg.n_experts % mesh.shape["model"] == 0
                 and kind in ("train", "prefill")
                 and shape.seq_len % mesh.shape["model"] == 0)
        moe_impl = "ep" if ep_ok else "einsum"
    decode_attn = "naive"
    if (kind == "decode" and mesh is not None
            and "model" in mesh.axis_names
            and shape.seq_len % mesh.shape["model"] == 0):
        decode_attn = "seq_sharded"
    q_ok, kv_ok = Sh.heads_shardable(cfg, mesh) if mesh is not None \
        else (False, False)
    kw = dict(
        attn_impl="blockwise",
        schedule="rect",
        q_block=512 if shape.seq_len >= 4096 else 256,
        kv_block=1024 if shape.seq_len >= 4096 else 256,
        moe_impl=moe_impl,
        moe_group=2048,
        remat=(kind == "train"),
        scan_layers=True,
        decode_attn=decode_attn,
        mesh=mesh,
        batch_axes=batch_axes_of(mesh) if mesh is not None else ("data",),
        heads_sharded=q_ok,
        repeat_kv=(q_ok and not kv_ok and not cfg.use_mla),
    )
    kw.update(overrides)
    return M.RunCfg(**kw)


def train_runcfg(arch, cfg, shape, mesh, **overrides) -> M.RunCfg:
    """``make_runcfg`` with the train branch of the reference's
    ``build_cell``: ``seq_parallel`` for ``TRAIN_SP``, the SSD tile of
    ``TRAIN_SSM_CHUNK`` (an override wins over both)."""
    run = make_runcfg(cfg, shape, mesh, **overrides)
    if arch in TRAIN_SP and "seq_parallel" not in overrides:
        run = run.replace(seq_parallel=True)
    if arch in TRAIN_SSM_CHUNK and not overrides.get("ssm_chunk"):
        run = run.replace(ssm_chunk=TRAIN_SSM_CHUNK[arch])
    return run


def train_accum(arch, mesh, global_batch) -> int:
    """``build_cell``'s train accumulation: ``TRAIN_ACCUM`` is calibrated
    for the 512-chip mesh, so a smaller mesh (twice the activations a
    chip) scales it by ``512 // mesh size``, capped by the batch rows each
    batch shard holds."""
    size = 1
    for a in mesh.axis_names:
        size *= mesh.shape[a]
    shards = 1
    for a in batch_axes_of(mesh):
        shards *= mesh.shape[a]
    accum = TRAIN_ACCUM.get(arch, 1) * max(1, 512 // max(size, 1))
    return min(accum, max(global_batch // shards, 1))


def batch_struct(cfg, B, S, *, labels=True) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of a batch, the reference's ``batch_struct``
    as shapes and dtypes."""
    out = {"tokens": ((B, S), torch.int32)}
    if labels:
        out["labels"] = ((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = ((B, cfg.encoder_seq, cfg.d_model),
                         torch_dtype(cfg.dtype))
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = ((3, B, S), torch.int32)
    return out
