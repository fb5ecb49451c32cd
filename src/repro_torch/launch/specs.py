"""Per-cell (architecture x input shape x mesh) plans for the dry run
(``launch/dryrun.py``), the port of the JAX package's ``launch/specs.py``:
meta-device inputs (shapes and dtypes, no memory), their placements on
the mesh, and the step function to run.

Shape kinds map to functions:
  train_*    -> train_step   (fwd+bwd+AdamW, microbatch accumulation)
  prefill_*  -> prefill      (full forward + cache construction)
  decode_* / long_* -> serve_step (one token against a seq_len KV cache)

The training launcher (``launch/train.py``) takes its layout from here
too: the per-arch defaults of a train cell, ``make_runcfg`` (the layout
knobs of a shape on a mesh), ``train_runcfg`` and ``train_accum`` (the
train branch of ``build_cell``: sequence parallelism, the SSD tile and
the accumulation scaled to the mesh) and the batch's shapes and dtypes.

Where the port lays a cell out differently from the reference, the plan
says what the port does: its serving paths (prefill, decode) run on
whole params on the controller's device, with only the expert-parallel
MoE's experts and the seq-sharded decode cache split over the mesh; its
train step splits the global batch itself (``batch_shardings``). A
placement of None leaves an input where it is (``sharding.place``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.distributed import sharding as Sh
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype
from repro_torch.training import optimizer as O
from repro_torch.training import train as T

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


def _meta(struct) -> Dict[str, torch.Tensor]:
    """{name: (shape, dtype)} as meta tensors."""
    return {n: torch.empty(sh, dtype=dt, device="meta")
            for n, (sh, dt) in struct.items()}


def params_struct(cfg):
    """The params at full size on the meta device: shapes and dtypes,
    no memory (``jax.eval_shape`` of the reference's init)."""
    return M.init_model(cfg, torch.Generator(), device="meta")


# ---------------------------------------------------------------------------
# Cell plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape_name: str
    kind: str
    fn: Any                     # positional fn: fn(*placed args)
    arg_structs: tuple          # meta tensors (global shapes)
    in_shardings: Any           # Sh.NamedSharding trees (None: as it is)
    out_shardings: Any
    cfg: Any
    run: Any
    notes: Dict[str, Any]
    donate: tuple = ()          # args updated in place (train: params+opt)


def _strip_model(specs):
    """Every param spec without the model axis (FSDP only)."""
    if isinstance(specs, dict):
        return {k: _strip_model(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_strip_model(v) for v in specs]
    return tuple(None if e == "model" else e for e in specs)


def build_cell(arch: str, shape_name, mesh, *, cfg=None,
               run_overrides=None, accum=None) -> CellPlan:
    """The plan of one cell. ``shape_name`` names one of ``SHAPES`` or is
    a ``ShapeConfig`` of its own. ``run_overrides`` may hold the
    reference's ``"_dp_only"``: no tensor parallelism, params FSDP over
    the data axes only, the model axis a replica of the batch."""
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    run_overrides = dict(run_overrides or {})
    dp_only = run_overrides.pop("_dp_only", False)
    run = make_runcfg(cfg, shape, mesh, **run_overrides)
    B, S = shape.global_batch, shape.seq_len
    if dp_only:
        run = run.replace(batch_axes=tuple(mesh.axis_names),
                          heads_sharded=False, repeat_kv=False,
                          moe_impl="scatter" if cfg.family == "moe"
                          else run.moe_impl)
    ps = params_struct(cfg)
    pspec = Sh.param_specs(ps, mesh, cfg)
    if dp_only:
        pspec = _strip_model(pspec)
    pshard = Sh._named(pspec, mesh)
    notes: Dict[str, Any] = {"moe_impl": run.moe_impl,
                             "decode_attn": run.decode_attn,
                             "heads_sharded": run.heads_sharded,
                             "repeat_kv": run.repeat_kv}

    if shape.kind == "train":
        if arch in TRAIN_SP and "seq_parallel" not in run_overrides:
            run = run.replace(seq_parallel=True)
            notes["seq_parallel"] = True
        if accum is None:
            accum = train_accum(arch, mesh, B)
        notes["accum"] = accum
        if arch in TRAIN_SSM_CHUNK and run_overrides.get(
                "ssm_chunk") is None:
            run = run.replace(ssm_chunk=TRAIN_SSM_CHUNK[arch])
            notes["ssm_chunk"] = run.ssm_chunk
        bs = _meta(batch_struct(cfg, B, S))
        os_ = O.init(ps)
        oshard = O.state_shardings(pshard)
        step = T.make_train_step(cfg, run, O.AdamWCfg(), accum=accum)
        # the step splits the global batch over the batch axes itself
        return CellPlan(arch, shape.name, "train", step, (ps, os_, bs),
                        (pshard, oshard, None), (pshard, oshard, None), cfg,
                        run, notes, donate=(0, 1))

    if shape.kind == "prefill":
        if arch in PREFILL_SSM_CHUNK and run_overrides.get(
                "ssm_chunk") is None:
            run = run.replace(ssm_chunk=PREFILL_SSM_CHUNK[arch])
            notes["ssm_chunk"] = run.ssm_chunk
        if arch in PREFILL_PIN_SSM and "pin_ssm" not in run_overrides:
            run = run.replace(pin_ssm=True)
            notes["pin_ssm"] = True
        bs = _meta(batch_struct(cfg, B, S, labels=False))

        def fn(params, batch):
            return M.prefill(cfg, params, batch, run, max_len=S)

        return CellPlan(arch, shape.name, "prefill", fn, (ps, bs),
                        (None, None), (None, None), cfg, run, notes)

    # decode: the cache's attention leaves seq-sharded where the run says
    cs = _meta(M.cache_struct(cfg, B, S))
    cshard = {n: Sh.NamedSharding(mesh, Sh.cache_specs({n: t}, mesh)[n])
              if run.decode_attn == "seq_sharded" and n in M.SEQ_LEAVES
              else None for n, t in cs.items()}
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")

    def fn(params, token, cache, cache_len):
        return M.serve_step(cfg, params, token, cache, cache_len, None, run,
                            temperature=0.0)

    return CellPlan(arch, shape.name, "decode", fn, (ps, tok, cs, S - 1),
                    (None, None, cshard, None), (None, cshard), cfg, run,
                    notes, donate=(2,))  # serving writes the cache in place


def probe_depths(cfg):
    """(cfg_d1, cfg_d2, full_stack, stack_at_d1) for layer extrapolation."""
    base = cfg.first_dense_layers if cfg.family == "moe" else 0
    full_stack = cfg.n_layers - base
    d1 = dataclasses.replace(cfg, n_layers=base + 1)
    d2 = dataclasses.replace(cfg, n_layers=base + 2)
    return d1, d2, full_stack, 1
