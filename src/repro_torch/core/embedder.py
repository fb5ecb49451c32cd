"""Query embedders for the port, behind one ``encode(texts) -> (n, dim)
L2-normalized float32`` interface, as in the JAX package's
``core/embedder.py``:

* ``HashEmbedder`` — signed n-gram feature hashing (the "hashing trick"):
  deterministic, no training, pure numpy, so its output is bitwise equal
  to the reference's.
* ``MiniLMEncoder`` — the all-MiniLM-class (6 layers, 384 wide) encoder
  with mean pooling: the reference's ``MiniLMEncoder`` in PyTorch. Its
  layers are the port's ``kind="enc"`` blocks, whose non-causal attention
  runs the ``flash_attention`` kernel on CUDA. Weights come from a seeded
  ``torch.Generator`` with the reference's shapes and scales, or from a
  given params dict (``models/convert.py:params_from_jax`` copies the
  reference's). ``train_contrastive`` trains it on paraphrase pairs with
  the reference's arithmetic (in-batch negatives, momentum SGD, numpy
  batch draws); its forward runs the plain attention under autograd, as
  the kernel has no backward.

MIPS on L2-normalized embeddings == cosine similarity (the paper's metric).
"""
from __future__ import annotations

import dataclasses
import re
import zlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models import model as M
from repro_torch.models.convert import tree_leaves

_WORDS = re.compile(r"\w+")


class HashEmbedder:
    def __init__(self, dim: int = 384, ngrams=(1, 2), seed: int = 0):
        self.dim = dim
        self.ngrams = ngrams
        self.seed = seed

    def _features(self, text: str):
        ws = _WORDS.findall(text.lower())
        feats = []
        for n in self.ngrams:
            for i in range(len(ws) - n + 1):
                feats.append(" ".join(ws[i:i + n]))
        return feats

    def encode(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for f in self._features(t):
                h = zlib.crc32((f + f"#{self.seed}").encode())
                idx = h % self.dim
                sign = 1.0 if (h >> 17) & 1 else -1.0
                out[i, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)


# ---------------------------------------------------------------------------
# MiniLM-class encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    vocab_size: int
    dim: int = 384
    n_layers: int = 6
    n_heads: int = 6
    d_ff: int = 1536
    max_len: int = 64


def _enc_model_cfg(cfg: EncoderCfg) -> ModelConfig:
    # the blocks keep ModelConfig's norm_eps (1e-5), as the reference's do
    return ModelConfig(
        name="minilm-enc", family="dense", n_layers=cfg.n_layers,
        d_model=cfg.dim, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
        d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
        head_dim=cfg.dim // cfg.n_heads, gated_mlp=False, mlp_act="gelu",
        rope_kind="none", dtype="float32")


class MiniLMEncoder:
    """Mean-pooled transformer encoder; ``encode`` batches + L2-normalizes.
    Runs on ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, tokenizer, cfg: EncoderCfg = None, seed: int = 0,
                 max_batch: int = 256, params: Optional[dict] = None,
                 device="cuda"):
        self.tok = tokenizer
        self.cfg = cfg or EncoderCfg(vocab_size=tokenizer.vocab_size)
        self.dim = self.cfg.dim
        self.max_batch = max_batch
        self.mcfg = _enc_model_cfg(self.cfg)
        self.device = torch.device(device)
        self.params = params if params is not None else self._init(seed)
        self._pos = Lyr.sinusoidal_positions(self.cfg.max_len,
                                             self.cfg.dim).to(self.device)

    def _init(self, seed: int) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        f32 = torch.float32
        return {
            "embed": {"w": Lyr._normal(gen, (self.cfg.vocab_size,
                                             self.cfg.dim),
                                       self.cfg.dim ** -0.5, f32,
                                       self.device)},
            "blocks": [M.init_block(gen, self.mcfg, f32, self.device,
                                    kind="enc")
                       for _ in range(self.cfg.n_layers)],
            "final_norm": Lyr.rmsnorm_init(self.cfg.dim, f32, self.device),
        }

    @torch.no_grad()
    def _forward(self, tokens, mask):
        """tokens (B, L) int64; mask (B, L) f32. Returns (B, dim)
        L2-normed. Every position attends to every other one, padding
        included (the mask only weights the pooling), as in the
        reference."""
        return self._pooled(tokens, mask, "kernel")

    def _pooled(self, tokens, mask, attn_impl):
        """``_forward`` without ``no_grad``; ``attn_impl`` as in
        ``models/model.py:RunCfg``."""
        x = self.params["embed"]["w"][tokens] + self._pos[None]
        pos = torch.arange(tokens.shape[1], device=self.device)[None] \
            .expand(tokens.shape)
        for lp in self.params["blocks"]:
            x, _, _ = M.block_fullseq(self.mcfg, lp, x, pos, kind="enc",
                                      run=M.RunCfg(attn_impl=attn_impl))
        # the final norm's eps is the reference's hard-coded 1e-6
        x = Lyr.rmsnorm(self.params["final_norm"], x, 1e-6)
        pooled = (x * mask[..., None]).sum(1) / torch.clamp(
            mask.sum(1, keepdim=True), min=1.0)
        return pooled / torch.clamp(
            torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-9)

    def _batch(self, texts, pad_to: int = 0):
        L = self.cfg.max_len
        rows = max(len(texts), pad_to)
        toks = np.zeros((rows, L), np.int64)
        mask = np.zeros((rows, L), np.float32)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)[:L]
            toks[i, :len(ids)] = ids
            mask[i, :len(ids)] = 1.0
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two: the batch sizes the encoder runs at stay few
        (serving microbatches and precompute waves arrive in many sizes)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def encode(self, texts: List[str]) -> np.ndarray:
        """Batched + L2-normalized. Batches are padded to power-of-two
        buckets (padding rows carry an all-zero mask and are sliced off)
        and chunked at ``max_batch``."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = []
        for lo in range(0, len(texts), self.max_batch):
            chunk = texts[lo:lo + self.max_batch]
            toks, mask = self._batch(chunk, pad_to=self._bucket(len(chunk)))
            out.append(self._forward(toks, mask)[:len(chunk)].cpu().numpy())
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    # -- contrastive training (InfoNCE over paraphrase pairs) --------------
    def train_contrastive(self, pairs, *, steps=200, bs=32, lr=1e-3,
                          temp=0.07, seed=0):
        """pairs: list of (text_a, text_b) positives. In-batch negatives:
        the symmetric InfoNCE loss at ``temp``, momentum SGD (``m = 0.9 m
        + 0.1 g; p -= lr m``) on every parameter, batches drawn by
        ``np.random.default_rng(seed)`` exactly as the reference draws
        them. Updates ``self.params`` in place; returns the per-step
        losses. The forward runs the plain attention (``attn_impl=
        "naive"``) on any device: the B4 kernel has no backward."""
        rng = np.random.default_rng(seed)
        leaves = list(tree_leaves(self.params))
        moms = [torch.zeros_like(p) for p in leaves]
        losses = []
        try:
            for p in leaves:
                p.requires_grad_(True)
            for _ in range(steps):
                idx = rng.choice(len(pairs), size=min(bs, len(pairs)),
                                 replace=False)
                ta, ma = self._batch([pairs[i][0] for i in idx])
                tb, mb = self._batch([pairs[i][1] for i in idx])
                za = self._pooled(ta, ma, "naive")
                zb = self._pooled(tb, mb, "naive")
                logits = za @ zb.T / temp
                ll = torch.log_softmax(logits, dim=-1)
                lt = torch.log_softmax(logits.T, dim=-1)
                loss = -(ll.diagonal().mean() + lt.diagonal().mean())
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for p, g, m in zip(leaves, grads, moms):
                        m.copy_(0.9 * m + 0.1 * g)
                        p.sub_(lr * m)
                losses.append(float(loss.detach()))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return losses

