"""Model assembly: init / forward / prefill / decode for every family of the
JAX package's ``models/model.py``: dense (llama / qwen / starcoder), vlm
(the dense backbone with M-RoPE: qwen2-vl), moe (deepseek: MLA + MoE;
grok: GQA + MoE), ssm (mamba2), hybrid (zamba2: Mamba2 backbone + one
weight-shared attention block; a layer pattern: Nemotron-H's single-mixer
blocks, each Mamba2, MoE or GQA attention, in ``cfg.layer_pattern``'s
order) and encdec (whisper: a non-causal encoder over precomputed frame
embeddings, a decoder with cross-attention).

Conventions
-----------
* The model API takes the reference's positional forms: ``prefill(cfg,
  params, batch, run, max_len)`` (``batch`` the reference's dict, or a
  token tensor), ``decode_step(cfg, params, token, cache, cache_len, run,
  mrope_positions)``, ``serve_step``, ``lm_logits(cfg, run, params, x)``.
  The layer-level functions take ``run`` as a keyword instead of the
  reference's second argument.
* Params are a dict: ``{"embed": {"w"}, "final_norm": {"scale"},
  "blocks": [one dict per layer]}`` with the reference's per-layer keys
  and shapes, plus ``"dense0"`` (deepseek's leading dense layers, a list
  like ``"blocks"``), ``"shared"`` (zamba2's one shared block, a single
  layer's dict) and ``"enc_blocks"``/``"enc_norm"`` (whisper's encoder).
  ``models/convert.py`` copies a reference pytree in and back out.
* ``layer_plan(cfg)`` is the one description of a config's stack: each
  layer's block kind, where its params sit and which cache leaves it
  reads. ``init_model``, the full-sequence stack (``forward``,
  ``lm_loss``, ``prefill``), ``cache_struct``, ``decode_step`` and the
  mesh's ``train_parallel`` read it; a new stack shape is described
  there alone.
* ``RunCfg`` carries the implementation choices: the reference's
  single-device knobs of a full-sequence pass and its mesh knobs
  (``mesh``, ``decode_attn="seq_sharded"``, ``moe_impl="ep"``, the axes).
  ``attn_impl``:
  ``"kernel"`` runs the ``flash_attention`` kernel on CUDA (its plain
  version on the CPU); it has no backward, so it raises on inputs that
  require grad. ``"naive"`` is that plain math on any device, under
  autograd; ``"blockwise"`` (the default, as in the reference) is the
  tiled attention of ``models/blockwise.py`` with a hand-written flash
  backward, what training runs. ``prefill``'s default ``run`` is
  ``KERNEL`` (the serving path; the reference's default is
  ``RunCfg()``, the same values); single-token GQA decode (self- and
  cross-attention)
  runs the ``decode_attention`` kernel on CUDA and its plain version on
  the CPU, which are the naive attention the reference engine runs
  (``RunCfg(attn_impl="naive")``). MLA's absorbed decode (one latent head
  of 576/512 over the compressed cache) and the MoE expert products are
  plain PyTorch, as they are plain einsums in the reference.
* Over a mesh (``launch/mesh.py``), ``decode_attn="seq_sharded"`` splits
  the attention caches' sequence dim over ``seq_axis`` (and their batch
  rows over ``batch_axes``): ``place_cache`` lays the ``k``/``v``/
  ``ak``/``av``/``ckv``/``krope`` leaves out per
  ``distributed/sharding.cache_specs`` as ``Sharded`` values, which
  ``decode_step`` indexes per layer and writes in place, and the decode
  attention is ``distributed/decode_attn.py``'s. ``moe_impl="ep"`` runs
  the MoE layers expert-parallel (``distributed/moe_parallel.py``).
* Decode caches, leading dim = layer (or shared-block invocation):
    GQA    : {"k": (L,B,M,Hkv,Dh), "v": (L,B,M,Hkv,Dh)}  (dense, vlm, moe)
    MLA    : {"ckv": (L,B,M,r), "krope": (L,B,M,dr)}
    SSM    : {"h": (L,B,H,P,N) f32, "conv": (L,B,W-1,C)}
    hybrid : SSM + {"ak"/"av": (I,B,M,Hkv,Dh)}, I = shared invocations
    pattern: SSM over the Mamba layers + GQA over the attention layers,
             each leaf's leading dim counting its own kind's layers
    encdec : GQA + {"xk"/"xv": (L,B,Tenc,Hkv,Dh)}, static after prefill
  Unlike the reference, which returns a new cache, ``decode_step`` writes
  INTO the cache it is given (no copy of the whole cache per step) and
  returns that same dict. Under ``live`` a dead slot computes its step as
  the reference's does (its new attention entry is written, attended and
  then put back; its SSM state is read and not written), so its rows of
  every leaf end the step as they began it: the reference's masked
  dead-slot writes (``serving/engine.py:60-82``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.distributed.decode_attn import (gqa_decode_seq_sharded,
                                                 mla_decode_seq_sharded)
from repro_torch.distributed.moe_parallel import moe_ffn_ep
from repro_torch.distributed.sharding import Sharded, cache_specs, shard
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as Lyr
from repro_torch.models import mla as Mla
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.models.blockwise import blockwise_gqa
from repro_torch.models.convert import tree_leaves

DECODE_SPLITS = 8      # split-KV chunks per decode_attention launch


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """Implementation knobs, not architecture: the reference's fields with
    its defaults. ``remat`` recomputes each layer's activations in the
    backward (memory, not values); ``scan_layers`` is accepted and has no
    effect (the port loops over its per-layer lists either way);
    ``logits_f32`` casts the logits; ``ssm_chunk`` overrides the config's
    SSD chunk (exact at any size). ``heads_sharded``, ``repeat_kv``,
    ``seq_parallel`` and ``pin_ssm`` lay out training on a mesh
    (``distributed/train_parallel.py``); on one device they change
    nothing."""
    attn_impl: str = "blockwise"      # kernel | naive | blockwise
    schedule: str = "rect"            # rect | tri (causal tile skipping)
    q_block: int = 512
    kv_block: int = 1024
    moe_impl: str = "scatter"         # scatter | einsum | ep
    moe_group: int = 2048
    remat: bool = True
    scan_layers: bool = True
    decode_attn: str = "naive"        # naive (one device) | seq_sharded
    mesh: Any = None                  # launch/mesh.Mesh of the mesh paths
    ep_axis: str = "model"
    seq_axis: str = "model"
    batch_axes: Tuple[str, ...] = ("data",)
    aux_coef: float = 0.01
    logits_f32: bool = False
    heads_sharded: bool = False       # q heads split over "model"
    repeat_kv: bool = False           # kv replicated, repeated to the q heads
    ssm_chunk: int = 0                # 0: the config's
    seq_parallel: bool = False        # residual stream split on the sequence
    pin_ssm: bool = False             # SSD batch-only (the port's only layout)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


KERNEL = RunCfg(attn_impl="kernel")   # the serving path's prefill
SMOKE = RunCfg(attn_impl="naive", remat=False, q_block=64, kv_block=64,
               moe_group=64)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(gen, cfg, dtype, device, kind="dense"):
    """One layer's params: ``"dense"`` (decoder; MLA attention when the
    config has it), ``"enc"`` (the non-causal encoder layer), ``"dec"``
    (whisper's decoder layer: self-attention, ``lnx`` and the
    cross-attention ``xattn``, MLP), ``"moe"``, ``"moe_dense0"``
    (deepseek's leading dense layer, ``d_ff_dense`` wide), ``"ssm"``, or a
    layer pattern's ``"experts"`` and ``"attn"`` (a norm and that one
    mixer)."""
    d = cfg.d_model
    if kind == "ssm":
        return {"ln": Lyr.rmsnorm_init(d, dtype, device),
                "ssm": Ssm.ssm_init(gen, cfg, dtype, device)}
    if kind == "experts":
        return {"ln": Lyr.rmsnorm_init(d, dtype, device),
                "moe": Moe.moe_init(gen, cfg, dtype, device)}
    if kind == "attn":
        return {"ln": Lyr.rmsnorm_init(d, dtype, device),
                "attn": Lyr.attention_init(gen, cfg, dtype, device)}
    if kind not in ("dense", "enc", "dec", "moe", "moe_dense0"):
        raise ValueError(f"block kind {kind!r}")
    attn = Mla.mla_init(gen, cfg, dtype, device) \
        if cfg.use_mla and kind not in ("enc", "dec") else \
        Lyr.attention_init(gen, cfg, dtype, device)
    p = {"ln1": Lyr.rmsnorm_init(d, dtype, device), "attn": attn}
    if kind == "dec":
        p["lnx"] = Lyr.rmsnorm_init(d, dtype, device)
        p["xattn"] = Lyr.cross_attention_init(gen, cfg, dtype, device)
    p["ln2"] = Lyr.rmsnorm_init(d, dtype, device)
    if kind == "moe":
        p["moe"] = Moe.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = (cfg.d_ff_dense or cfg.d_ff) if kind == "moe_dense0" else None
        p["mlp"] = Lyr.mlp_init(gen, cfg, dtype, device, d_ff=d_ff)
    return p


# ---------------------------------------------------------------------------
# The layer plan: each config's stack, described once
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layer:
    """One entry of a layer plan. ``kind`` as ``init_block``,
    ``block_fullseq`` and ``block_decode`` take it; ``params`` where its
    params sit (``("blocks", i)``, ``("dense0", i)`` or ``("shared",)``);
    ``cache`` the decode-cache leaves it reads, as (name in its slice,
    cache leaf, index along the leaf's leading dim); ``mixer`` the kind
    of its ``decode.mixer`` span (a layer pattern's layers only)."""
    kind: str
    params: Tuple
    cache: Tuple = ()
    mixer: Optional[str] = None


# a layer pattern's letters: (block kind, mixer, cache leaves)
_LETTERS = {"M": ("ssm", "ssm", ("h", "conv")),
            "E": ("experts", "moe", ()),
            "*": ("attn", "attn", ("k", "v"))}


# the decode cache's leaves in the order ``cache_struct`` and ``prefill``
# give them; those with a sequence dim, which ``prefill`` pads and the
# seq-sharded decode attends (CACHE_RULES' SEQ rows)
CACHE_LEAVES = ("ckv", "krope", "h", "conv", "k", "v", "xk", "xv", "ak",
                "av")
SEQ_LEAVES = ("k", "v", "ak", "av", "ckv", "krope")


@functools.lru_cache(maxsize=64)
def layer_plan(cfg) -> Tuple[Layer, ...]:
    """The stack in running order: a layer pattern's blocks, each kind's
    cache leaves indexed within that kind; zamba2's Mamba-2 layers with
    the one shared attention block before every ``hybrid_attn_every``-th,
    reading ``ak``/``av`` at its invocation; else a uniform stack
    (deepseek's ``dense0`` layers first) whose leaves are indexed by
    layer. The encoder-decoder's encoder is not part of it."""
    if cfg.layer_pattern:
        seen, out = dict.fromkeys(_LETTERS, 0), []
        for i, c in enumerate(cfg.layer_pattern):
            kind, mixer, leaves = _LETTERS[c]
            out.append(Layer(kind, ("blocks", i),
                             tuple((n, n, seen[c]) for n in leaves), mixer))
            seen[c] += 1
        return tuple(out)
    if cfg.family == "hybrid":
        k, out = cfg.hybrid_attn_every, []
        for i in range(cfg.n_layers):
            if k and i % k == 0:
                out.append(Layer("dense", ("shared",),
                                 (("k", "ak", i // k), ("v", "av", i // k))))
            out.append(Layer("ssm", ("blocks", i),
                             (("h", "h", i), ("conv", "conv", i))))
        return tuple(out)
    attn = ("ckv", "krope") if cfg.use_mla else ("k", "v")
    kind, leaves = {"dense": ("dense", attn), "vlm": ("dense", attn),
                    "moe": ("moe", attn), "ssm": ("ssm", ("h", "conv")),
                    "encdec": ("dec", attn + ("xk", "xv"))}[cfg.family]
    n0 = cfg.first_dense_layers if cfg.family == "moe" else 0
    return tuple(Layer(kind if i >= n0 else "moe_dense0",
                       ("blocks", i - n0) if i >= n0 else ("dense0", i),
                       tuple((n, n, i) for n in leaves))
                 for i in range(cfg.n_layers))


def _params_at(params, where):
    p = params[where[0]]
    return p[where[1]] if len(where) > 1 else p


def init_model(cfg, generator: torch.Generator, dtype=None, device="cuda"):
    """Random weights from a seeded generator (on ``device``), with the
    reference's shapes and scales; the numbers differ from
    ``jax.random``'s, so parity tests copy reference params instead."""
    dtype = Lyr.torch_dtype(dtype or cfg.dtype)
    vp = cfg.padded_vocab
    params = {
        "embed": {"w": Lyr._normal(generator, (vp, cfg.d_model),
                                   cfg.d_model ** -0.5, dtype, device)},
        "final_norm": Lyr.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Lyr.dense_init(generator, cfg.d_model, vp, dtype,
                                           device)
    kinds = {e.params: e.kind for e in layer_plan(cfg)}
    # the tree's order (deepseek's blocks before its dense0), which the
    # generator's draws and storbench's weight fill follow
    for group in ("blocks", "dense0", "shared"):
        made = [init_block(generator, cfg, dtype, device, kinds[w])
                for w in sorted(w for w in kinds if w[0] == group)]
        if made:
            params[group] = made[0] if group == "shared" else made
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = [init_block(generator, cfg, dtype, device,
                                           "enc")
                                for _ in range(cfg.n_encoder_layers)]
        params["enc_norm"] = Lyr.rmsnorm_init(cfg.d_model, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Attention (full sequence)
# ---------------------------------------------------------------------------


def _attend(q, k, v, causal, run):
    if run.attn_impl == "kernel":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(
                "attn_impl='kernel': the flash_attention kernel has no "
                "backward; differentiate with attn_impl='blockwise' or "
                "'naive'")
        return ops.flash_attention(q, k, v, causal)
    if run.attn_impl == "naive":
        return flash_attention_plain(q, k, v, causal)
    if run.attn_impl == "blockwise":
        return blockwise_gqa(q, k, v, causal=causal, q_block=run.q_block,
                             kv_block=run.kv_block, schedule=run.schedule)
    raise ValueError(f"attn_impl must be 'kernel', 'naive' or 'blockwise', "
                     f"got {run.attn_impl!r}")


def gqa_fullseq(cfg, p, x, positions, *, causal=True, run=KERNEL,
                mrope_positions=None):
    """Returns (out (B,S,d), {"k","v"}) for a full sequence: prefill,
    training, the encoders. ``run.attn_impl`` picks the attention."""
    B, S, _ = x.shape
    q, k, v = Lyr.qkv(cfg, p, x, positions, mrope_positions)
    out = _attend(q, k, v, causal, run)
    return Lyr.dense(p["wo"], out.reshape(B, S, -1)), {"k": k, "v": v}


def mla_fullseq(cfg, p, x, positions, *, run=KERNEL):
    """MLA prefill: the compressed KV expanded per head, causal attention
    with q/k of nope + rope and v of ``v_head_dim`` (B4 zero-pads v to the
    q/k width, which is exact). Returns (out, {"ckv","krope"}): the cache
    stays compressed."""
    B, S, _ = x.shape
    q, k, v, kv = Mla.expand(cfg, p, x, positions)
    out = _attend(q, k, v, True, run)
    return Lyr.dense(p["wo"], out.reshape(B, S, -1)), kv


def attn_fullseq(cfg, p, x, positions, *, run=KERNEL, **kw):
    """A layer's self-attention over a full sequence: MLA where the config
    has it (which takes no ``mrope_positions`` and is always causal), else
    GQA. Returns (out, this layer's cache entries)."""
    if cfg.use_mla:
        kw.pop("mrope_positions", None)
        kw.pop("causal", None)
        return mla_fullseq(cfg, p, x, positions, run=run, **kw)
    return gqa_fullseq(cfg, p, x, positions, run=run, **kw)


def cross_fullseq(cfg, p, x, enc_out, run=KERNEL):
    """Whisper's cross-attention over the encoder output (no mask, no
    RoPE; B4 non-causal with S = the decoder's length, T = the encoder's).
    Returns (out, {"xk","xv"}): the projected encoder keys and values,
    which the decode cache keeps."""
    B, S, _ = x.shape
    q, xk, xv = Lyr.cross_qkv(cfg, p, x, enc_out)
    out = _attend(q, xk, xv, False, run)
    return Lyr.dense(p["wo"], out.reshape(B, S, -1)), {"xk": xk, "xv": xv}


# ---------------------------------------------------------------------------
# Attention (single-token decode)
# ---------------------------------------------------------------------------


def _per_row(cache_len) -> bool:
    """Whether ``cache_len`` gives each row its own position (a (B,)
    tensor) rather than one for the batch."""
    return torch.is_tensor(cache_len) and cache_len.dim() == 1


def _write(c, at, new, live):
    """Write ``new`` (B, ...) at the index ``at`` (``_decode_pos``) of the
    cache slice ``c`` (B, M, ...) in place; returns what a dead slot must
    get back (None when every slot is live)."""
    if torch.is_tensor(at):     # per-row positions: along dim 1
        old = None if live is None else c.gather(1, at)
        c.scatter_(1, at, new.to(c.dtype)[:, None])
        return old
    old = None if live is None else c[at].clone()
    c[at] = new.to(c.dtype)
    return old


def _restore(c, at, old, live):
    """Put a dead slot's entry at ``at`` back after its step attended it."""
    if live is None:
        return
    keep = live.view((-1,) + (1,) * (old.dim() - 1))
    if torch.is_tensor(at):
        c.scatter_(1, at, torch.where(keep, c.gather(1, at), old))
    else:
        c[at] = torch.where(keep, c[at], old)


def _decode_pos(cache_len, c):
    """The index of the write position in the cache slice ``c`` (B, M,
    ...): ``c[:, cache_len]``, or with per-row positions each row's own,
    as a ``gather``/``scatter_`` index along dim 1. A write past the end
    lands on the last slot, as the reference's clamping
    dynamic_update_slice does."""
    if not _per_row(cache_len):
        return slice(None), min(cache_len, c.shape[1] - 1)
    B = c.shape[0]
    return cache_len.clamp(max=c.shape[1] - 1).view(
        (B, 1) + (1,) * (c.dim() - 2)).expand((B, 1) + tuple(c.shape[2:]))


def _seq_sharded(run) -> bool:
    if run.decode_attn == "naive":
        return False
    if run.decode_attn != "seq_sharded":
        raise ValueError(f"decode_attn must be 'naive' or 'seq_sharded', "
                         f"got {run.decode_attn!r}")
    if run.mesh is None:
        raise ValueError("decode_attn='seq_sharded' needs RunCfg(mesh=...)")
    return True


def gqa_decode(cfg, p, x, kc, vc, cache_len, lengths, live=None,
               mrope_positions=None, run=RunCfg()):
    """x (B,1,d); kc/vc (B,M,Hkv,Dh), written in place at ``cache_len``
    (put back afterwards for the rows where ``live`` is False): an int,
    or a (B,) long tensor of each row's own position. M-RoPE positions
    default to ``cache_len`` on all three streams, as in the reference.
    ``run.decode_attn="seq_sharded"``: kc/vc are ``Sharded`` over
    ``run.seq_axis`` (int ``cache_len`` only). Returns out (B,1,d)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    Hq = cfg.n_heads
    if not _per_row(cache_len):
        positions = torch.full((B, 1), cache_len, dtype=torch.long,
                               device=x.device)
    else:
        positions = cache_len[:, None]
    if mrope_positions is None and cfg.rope_kind == "mrope":
        mrope_positions = positions[None].expand(3, B, 1)
    q, k, v = Lyr.qkv(cfg, p, x, positions, mrope_positions)
    if _seq_sharded(run):
        out, _, _ = gqa_decode_seq_sharded(
            q, k, v, kc, vc, cache_len, mesh=run.mesh, seq_axis=run.seq_axis,
            batch_axes=run.batch_axes, live=live)
    else:
        at = _decode_pos(cache_len, kc)
        olds = [_write(c, at, new[:, 0], live)
                for c, new in ((kc, k), (vc, v))]
        out = ops.decode_attention(q[:, 0], kc, vc, lengths, DECODE_SPLITS)
        for c, old in zip((kc, vc), olds):
            _restore(c, at, old, live)
    # the reference's P.V einsum yields the cache dtype (bf16 for the
    # batched cache) before the f32 output projection
    out = out.to(kc.dtype).to(x.dtype)
    return Lyr.dense(p["wo"], out.reshape(B, 1, Hq * hd))


def cross_decode(cfg, p, x, xk, xv):
    """One token's cross-attention over the static encoder keys and values
    xk/xv (B,Te,Hkv,Dh): B3 with ``lengths = Te - 1`` attends every
    position (its mask is inclusive), the reference's unmasked
    ``gqa_scores_softmax_out``. Returns out (B,1,d)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = Lyr.dense(p["wq"], x).reshape(B, cfg.n_heads, hd)
    lengths = torch.full((B,), xk.shape[1] - 1, dtype=torch.int32,
                         device=x.device)
    out = ops.decode_attention(q, xk, xv, lengths, DECODE_SPLITS)
    out = out.to(xk.dtype).to(x.dtype)
    return Lyr.dense(p["wo"], out.reshape(B, 1, cfg.n_heads * hd))


def mla_decode(cfg, p, x, ckv_c, krope_c, cache_len: int, live=None,
               run=RunCfg()):
    """Absorbed decode over the compressed cache ckv_c (B,M,r) and krope_c
    (B,M,dr), written in place at ``cache_len`` as ``gqa_decode`` writes
    (``models/mla.py``'s ``absorbed_attention``; seq-sharded under
    ``run.decode_attn``)."""
    B = x.shape[0]
    scale = Mla.scale_of(cfg)
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q_c, qr, ckv_new, krope_new = Mla.absorbed_q(cfg, p, x, positions)
    if _seq_sharded(run):
        out_c, _, _ = mla_decode_seq_sharded(
            q_c, qr, ckv_new, krope_new[:, :, 0, :], ckv_c, krope_c,
            cache_len, scale, mesh=run.mesh, seq_axis=run.seq_axis,
            batch_axes=run.batch_axes, live=live)
        return Mla.absorbed_out(cfg, p, out_c, x.dtype)
    at = _decode_pos(cache_len, ckv_c)
    olds = [_write(ckv_c, at, ckv_new[:, 0], live),
            _write(krope_c, at, krope_new[:, 0, 0], live)]
    out_c = Mla.absorbed_attention(q_c, qr, ckv_c, krope_c, cache_len, scale)
    for c, old in zip((ckv_c, krope_c), olds):
        _restore(c, at, old, live)
    return Mla.absorbed_out(cfg, p, out_c, x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def apply_moe(cfg, p, x, *, run=KERNEL, with_aux=True):
    """The MoE FFN on its pre-norm input by ``run.moe_impl`` (scatter,
    einsum, or expert-parallel over ``run.mesh``). Returns (y, the
    load-balance loss); without ``with_aux`` the scatter dispatch skips
    the loss, which only training reads (then None)."""
    if run.moe_impl == "ep":
        if run.mesh is None:
            raise ValueError("moe_impl='ep' needs RunCfg(mesh=...)")
        return moe_ffn_ep(cfg, p, x, mesh=run.mesh, ep_axis=run.ep_axis,
                          batch_axes=run.batch_axes)
    if run.moe_impl == "einsum":
        return Moe.moe_ffn_einsum(cfg, p, x, run.moe_group)
    if run.moe_impl != "scatter":
        raise ValueError(f"moe_impl must be 'scatter', 'einsum' or 'ep', "
                         f"got {run.moe_impl!r}")
    if with_aux:
        return Moe.moe_ffn(cfg, p, x, with_aux=True)
    return Moe.moe_ffn(cfg, p, x), None


def _ffn(cfg, p, x, kind, run=KERNEL, with_aux=False):
    """The layer's FFN on its pre-norm input; with ``with_aux`` also the
    MoE load-balance loss (0 for a dense layer), which training reads."""
    h = Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind != "moe":
        y = Lyr.mlp(cfg, p["mlp"], h)
        return (y, x.new_zeros((), dtype=torch.float32)) if with_aux else y
    y, aux = apply_moe(cfg, p["moe"], h, run=run, with_aux=with_aux)
    return (y, aux) if with_aux else y


def block_fullseq(cfg, p, x, positions, kind="dense", run=KERNEL, *,
                  mrope_positions=None, enc_out=None, with_aux=False):
    """One layer over a full sequence: ``"dense"``/``"moe"``/
    ``"moe_dense0"``/``"dec"`` attend causally (``"dec"`` then to
    ``enc_out`` through its cross-attention), ``"enc"`` to every position,
    ``"ssm"`` runs the SSD scan, a layer pattern's ``"experts"`` its MoE
    and ``"attn"`` its causal GQA, each alone. Returns (x, aux, this
    layer's cache entries); ``aux`` is the MoE load-balance loss when
    ``with_aux`` (else None)."""
    if kind == "ssm":
        h, (hs, conv) = Ssm.ssm_forward(
            cfg, p["ssm"], Lyr.rmsnorm(p["ln"], x, cfg.norm_eps),
            chunk=run.ssm_chunk or None)
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        return x + h, aux, {"h": hs, "conv": conv}
    if kind == "experts":
        y, aux = apply_moe(cfg, p["moe"], Lyr.rmsnorm(p["ln"], x,
                                                      cfg.norm_eps),
                           run=run, with_aux=with_aux)
        return x + y, aux, {}
    if kind == "attn":
        h, kv = gqa_fullseq(cfg, p["attn"], Lyr.rmsnorm(p["ln"], x,
                                                        cfg.norm_eps),
                            positions, run=run)
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        return x + h, aux, kv
    if kind not in ("dense", "enc", "dec", "moe", "moe_dense0"):
        raise ValueError(f"block kind {kind!r}")
    xin = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, kv = attn_fullseq(cfg, p["attn"], xin, positions, run=run,
                         causal=(kind != "enc"),
                         mrope_positions=mrope_positions)
    x = x + h
    if kind == "dec":
        h, xkv = cross_fullseq(cfg, p["xattn"],
                               Lyr.rmsnorm(p["lnx"], x, cfg.norm_eps),
                               enc_out, run)
        x = x + h
        kv = dict(kv, **xkv)
    if with_aux:
        y, aux = _ffn(cfg, p, x, kind, run, with_aux=True)
        return x + y, aux, kv
    return x + _ffn(cfg, p, x, kind, run), None, kv


def block_decode(cfg, p, x, csl, cache_len, lengths, live=None,
                 kind="dense", mrope_positions=None, run=RunCfg()):
    """One layer, one token; ``csl`` is this layer's cache slice (its
    leaves without the layer dim), updated in place. ``cache_len`` as
    ``decode_step`` takes it. ``run`` picks the decode attention and the
    MoE dispatch."""
    if kind == "ssm":
        h, (hs, conv) = Ssm.ssm_decode(
            cfg, p["ssm"], Lyr.rmsnorm(p["ln"], x, cfg.norm_eps), csl["h"],
            csl["conv"])
        for name, new in (("h", hs), ("conv", conv)):
            c = csl[name]
            if live is not None:
                new = torch.where(live.view((-1,) + (1,) * (c.dim() - 1)),
                                  new, c)
            c.copy_(new)
        return x + h
    if kind == "experts":
        y, _ = apply_moe(cfg, p["moe"], Lyr.rmsnorm(p["ln"], x, cfg.norm_eps),
                         run=run, with_aux=False)
        return x + y
    if kind == "attn":
        return x + gqa_decode(cfg, p["attn"],
                              Lyr.rmsnorm(p["ln"], x, cfg.norm_eps),
                              csl["k"], csl["v"], cache_len, lengths, live,
                              run=run)
    xin = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        h = mla_decode(cfg, p["attn"], xin, csl["ckv"], csl["krope"],
                       cache_len, live, run)
    else:
        h = gqa_decode(cfg, p["attn"], xin, csl["k"], csl["v"], cache_len,
                       lengths, live, mrope_positions, run)
    x = x + h
    if kind == "dec":
        x = x + cross_decode(cfg, p["xattn"],
                             Lyr.rmsnorm(p["lnx"], x, cfg.norm_eps),
                             csl["xk"], csl["xv"])
    return x + _ffn(cfg, p, x, kind, run)


# ---------------------------------------------------------------------------
# Embedding / head / positions
# ---------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens, dtype=None):
    """The token lookup (``dtype`` is accepted and unused, as in the
    reference)."""
    return params["embed"]["w"][tokens]


def lm_logits(cfg, run, params, x):
    """The final norm and head, the Megatron vocab padding masked; f32
    with ``run.logits_f32``."""
    x = Lyr.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["w"].T
    else:
        logits = Lyr.dense(params["lm_head"], x)
    if cfg.padded_vocab != cfg.vocab_size:   # mask Megatron vocab padding
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits.float() if run.logits_f32 else logits


@functools.lru_cache(maxsize=None)
def _sinusoid(seq_len: int, d_model: int, device: torch.device):
    # one host->device copy per (length, width, device), not one a step
    return Lyr.sinusoidal_positions(seq_len, d_model).to(device)


def _positions(batch, tokens):
    """The batch's ``positions`` (B,S), else 0..S-1 on every row."""
    if batch.get("positions") is not None:
        return batch["positions"].to(tokens.device)
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _encode(cfg, params, frames, run=KERNEL):
    """Whisper's encoder over (stub-)precomputed frame embeddings (B, Te,
    d), taken in the params' dtype (torch does not mix dtypes in a
    product): sinusoidal positions added, ``n_encoder_layers``
    non-causal layers, ``enc_norm``."""
    B, Te, _ = frames.shape
    frames = frames.to(params["enc_norm"]["scale"].dtype)
    x = frames + _sinusoid(Te, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    pos = torch.arange(Te, device=frames.device)[None].expand(B, Te)
    for p in params["enc_blocks"]:
        x, _, _ = block_fullseq(cfg, p, x, pos, kind="enc", run=run)
    return Lyr.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Full sequence: the layer stack shared by forward and prefill
# ---------------------------------------------------------------------------


def _pad_seq(t, max_len: int):
    """(L, B, S, ...) zero-padded to (L, B, max_len, ...)."""
    S = t.shape[2]
    if max_len <= S:
        return t
    out = t.new_zeros(tuple(t.shape[:2]) + (max_len,) + tuple(t.shape[3:]))
    out[:, :, :S] = t
    return out


def _run_stack(cfg, params, tokens, run, *, positions, frames=None,
               mrope_positions=None, with_aux=False, build_cache=False):
    """Embed ``tokens`` and run every layer of the plan. Returns (x
    (B,S,d), the MoE aux loss summed over layers (None unless
    ``with_aux``), each cache leaf stacked over the entries that read it
    (None unless ``build_cache``))."""
    x = embed_tokens(cfg, params, tokens)
    aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
    enc_out = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder needs frames "
                             "(B, encoder_seq, d_model)")
        enc_out = _encode(cfg, params, frames, run)
        x = x + _sinusoid(tokens.shape[1], cfg.d_model, x.device).to(
            x.dtype)[None]
    remat = run.remat and not build_cache and torch.is_grad_enabled()
    leaves = {}
    for e in layer_plan(cfg):
        p = _params_at(params, e.params)
        if remat:    # the layer's activations are recomputed in backward
            x, a, kv = checkpoint(block_fullseq, cfg, p, x, positions, e.kind,
                                  run, with_aux=with_aux, use_reentrant=False,
                                  mrope_positions=mrope_positions,
                                  enc_out=enc_out)
        else:
            x, a, kv = block_fullseq(cfg, p, x, positions, e.kind, run,
                                     with_aux=with_aux, enc_out=enc_out,
                                     mrope_positions=mrope_positions)
        if with_aux:
            aux = aux + a
        if build_cache:
            for n, leaf, _ in e.cache:
                leaves.setdefault(leaf, []).append(kv[n])
    cache = {n: torch.stack(leaves[n]) for n in CACHE_LEAVES
             if n in leaves} if build_cache else None
    return x, aux, cache


def forward(cfg, params, batch, run=RunCfg()):
    """Full-sequence forward over ``batch`` ({"tokens" (B,S)} and, per
    family, "frames" (B,Te,d), "mrope_positions" (3,B,S), "positions"
    (B,S)). Returns (logits (B,S,V), {"moe_aux": the load-balance loss
    summed over MoE layers, f32})."""
    tokens = batch["tokens"]
    x, aux, _ = _run_stack(cfg, params, tokens, run,
                           positions=_positions(batch, tokens),
                           frames=batch.get("frames"),
                           mrope_positions=batch.get("mrope_positions"),
                           with_aux=True)
    return lm_logits(cfg, run, params, x), {"moe_aux": aux}


def lm_loss(cfg, params, batch, run=RunCfg()):
    """Causal LM cross-entropy over ``batch["labels"]`` (-1 ignored) plus
    ``run.aux_coef`` times the MoE aux loss. Returns (loss, {"loss": the
    cross-entropy, "moe_aux"})."""
    logits, aux = forward(cfg, params, batch, run)
    labels = batch["labels"]
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    picked = lg.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - picked
    valid = (labels >= 0).float()
    loss = (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return loss + run.aux_coef * aux["moe_aux"], {
        "loss": loss, "moe_aux": aux["moe_aux"]}


# ---------------------------------------------------------------------------
# Prefill / cache / decode
# ---------------------------------------------------------------------------


def prefill(cfg, params, batch, run=KERNEL, max_len: Optional[int] = None):
    """``batch``: the reference's dict ({"tokens" (B,S)} and, per family,
    "positions" (B,S), "frames" (B,Te,d), "mrope_positions" (3,B,S)) or a
    token tensor (B,S). Returns (logits of the last position (B,1,V),
    cache with the self-attention seq dims zero-padded to ``max_len``) in
    the params' dtype (``h`` f32). ``run`` picks the attention (by
    default every attention runs B4 on CUDA) and the MoE dispatch; with
    ``run.decode_attn="seq_sharded"`` the cache comes back laid out for it
    (``place_cache``)."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    tokens = batch["tokens"]
    max_len = max_len or tokens.shape[1]
    x, _, cache = _run_stack(cfg, params, tokens, run,
                             positions=_positions(batch, tokens),
                             frames=batch.get("frames"),
                             mrope_positions=batch.get("mrope_positions"),
                             build_cache=True)
    # xk/xv keep the encoder's length; the SSM leaves have no seq dim
    cache = {n: _pad_seq(t, max_len) if n in SEQ_LEAVES else t
             for n, t in cache.items()}
    if _seq_sharded(run):
        place_cache(cache, run)
    return lm_logits(cfg, run, params, x[:, -1:]), cache


def cache_struct(cfg, batch, max_len, dtype=None):
    """{name: (shape, dtype)} of the decode cache (``h`` always f32): each
    leaf the plan reads, its leading dim the entries that read it."""
    dt = Lyr.torch_dtype(dtype or cfg.dtype)
    B, M = batch, max_len
    heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
    N = cfg.ssm_state
    C = cfg.d_inner_ssm + 2 * cfg.ssm_n_groups * N
    kv, xkv = ((B, M) + heads, dt), ((B, cfg.encoder_seq) + heads, dt)
    one = {"ckv": ((B, M, cfg.kv_lora_rank), dt),
           "krope": ((B, M, cfg.qk_rope_head_dim), dt),
           "h": ((B, cfg.n_ssm_heads, cfg.ssm_head_dim, N), torch.float32),
           "conv": ((B, cfg.ssm_conv - 1, C), dt), "k": kv, "v": kv,
           "xk": xkv, "xv": xkv, "ak": kv, "av": kv}
    n = collections.Counter(leaf for e in layer_plan(cfg)
                            for _, leaf, _ in e.cache)
    return {leaf: ((n[leaf],) + one[leaf][0], one[leaf][1])
            for leaf in CACHE_LEAVES if n[leaf]}


def place_cache(cache, run):
    """Lay the attention leaves of ``cache`` out for
    ``run.decode_attn="seq_sharded"``, in place in the dict: each becomes
    a ``Sharded`` per ``cache_specs`` on ``run.mesh`` (sequence over the
    model axis, batch rows over the batch axes where they divide). The
    other leaves (SSM state, the cross-attention's ``xk``/``xv``) stay
    whole where they are. Returns ``cache``."""
    for n, t in cache.items():
        if n in SEQ_LEAVES and not isinstance(t, Sharded):
            cache[n] = shard(t, cache_specs({n: t}, run.mesh)[n], run.mesh)
    return cache


def per_row_positions(cfg, run=RunCfg()) -> bool:
    """Whether ``decode_step`` takes a (B,) tensor of per-row positions:
    GQA self-attention on one device, in a uniform stack or a layer
    pattern (whose Mamba-2 and MoE blocks take no position). MLA's
    absorbed decode, the uniform SSM and hybrid families, the
    encoder-decoder's position table and the seq-sharded decode take one
    position for the batch."""
    return (not cfg.use_mla and not cfg.is_encoder_decoder
            and (bool(cfg.layer_pattern)
                 or cfg.family not in ("ssm", "hybrid"))
            and not _seq_sharded(run))


def init_cache(cfg, batch, max_len, dtype=None, device="cuda", run=None):
    """Zeros per ``cache_struct`` on ``device``; laid out by
    ``place_cache`` when ``run`` asks for the seq-sharded decode."""
    cache = {n: torch.zeros(s, dtype=d, device=device)
             for n, (s, d) in cache_struct(cfg, batch, max_len,
                                           dtype).items()}
    return place_cache(cache, run) if run is not None and \
        _seq_sharded(run) else cache


def decode_step(cfg, params, token, cache, cache_len, run=RunCfg(),
                mrope_positions=None, *, live=None):
    """token (B,1) int; cache per ``cache_struct`` (updated in place);
    cache_len: the position this token is written at (it attends
    [0, cache_len]): an int for every row, or a (B,) long tensor on the
    token's device with each row's own position, which GQA models and
    layer patterns on one device take (``per_row_positions``). ``live``
    (B,) bool keeps the cache rows of dead slots as they were.
    ``mrope_positions`` (3,B,1): the vlm's position of this token
    (default ``cache_len`` on every stream). ``run`` picks the decode
    attention and the MoE dispatch; with ``decode_attn="seq_sharded"`` a
    cache not yet laid out for it is laid out in place (``place_cache``).
    Returns (logits (B,1,V), cache)."""
    B = token.shape[0]
    if _seq_sharded(run):
        place_cache(cache, run)
    x = embed_tokens(cfg, params, token)
    if not _per_row(cache_len):
        lengths = torch.full((B,), cache_len, dtype=torch.int32,
                             device=token.device)
    elif not per_row_positions(cfg, run):
        raise ValueError(f"{cfg.name}: per-row decode positions need GQA "
                         "attention on one device (a dense, vlm or GQA moe "
                         "decoder or a layer pattern, decode_attn='naive')")
    else:
        # a new tensor every step: B3's callers may keep it past the step
        lengths = cache_len.to(torch.int32, copy=True)
    if cfg.is_encoder_decoder:
        # the position row at cache_len, clamped past the end as the
        # reference's dynamic_slice is
        M = cache["k"].shape[2]
        x = x + _sinusoid(M, cfg.d_model, x.device)[
            min(cache_len, M - 1)].to(x.dtype)
    for i, e in enumerate(layer_plan(cfg)):
        ts = trace.start() if e.mixer else None
        x = block_decode(cfg, _params_at(params, e.params), x,
                         {n: cache[leaf][j] for n, leaf, j in e.cache},
                         cache_len, lengths, live, kind=e.kind,
                         mrope_positions=mrope_positions, run=run)
        if ts is not None:
            trace.end(ts, "decode.mixer", kind=e.mixer, layer=i)
    return lm_logits(cfg, run, params, x), cache


def serve_step(cfg, params, token, cache, cache_len: int, rng, run=RunCfg(),
               temperature=0.0):
    """``decode_step`` and the next token: (next (B,1) long, cache).
    Greedy (first-occurrence argmax) unless ``temperature`` > 0, then a
    sample from softmax(logits / temperature) drawn with ``rng`` (a
    ``torch.Generator`` on the logits' device, or None for torch's
    default): ``jax.random``'s stream cannot be reproduced, so sampled
    tokens match the reference in distribution only."""
    logits, cache = decode_step(cfg, params, token, cache, cache_len, run)
    lg = logits[:, -1, :].float()
    if temperature and temperature > 0:
        nxt = torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1,
                                generator=rng)[:, 0]
    else:
        nxt = torch.argmax(lg, dim=-1)
    return nxt[:, None], cache


def count_params(params) -> int:
    """The number of parameter elements (a ``Sharded`` leaf counts its
    global shape once)."""
    return sum(math.prod(t.shape) for t in tree_leaves(params))
