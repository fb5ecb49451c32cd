"""Plain PyTorch forward passes of the two served configurations, the
reference the benchmark holds each miss's logits to.

* ``dense``: starcoder2-7b as the configuration file states it is run:
  pre-RMS norms, GQA with q/k/v biases and rotate-half RoPE, a non-gated
  GELU (tanh) MLP, an untied head.
* ``mla_moe``: deepseek-v2-lite-16b: MLA (q of 128 nope + 64 rope per
  head, a 512-rank normalised latent and one shared roped key head, no q
  compression; RoPE and the softmax scale as the configuration's YaRN
  group gives them), a first dense SwiGLU layer, then MoE layers of softmax
  routing over the routed experts with top-k weights renormalised, plus
  the shared experts, under the configuration's per-call expert capacity
  (``_capacity_keep``).

One call runs the whole sequence (the prompt, then every served token but
the last) and returns the logits that predict each served token. The
configuration's cache precision is applied where the program's timed path
keeps its cache: the prompt's own positions attend in f32 (a prefill), a
served position attends over keys and values held in ``cache_dtype``
with its attention probabilities and output rounded to it, as the
configuration's decode states. Everything else is f32 with TF32 off,
unless ``dtype`` (the control) asks for another precision of weights and
activations. The weights are the benchmark's tensors; nothing here comes
from the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x, scale, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * scale


def _yarn_mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope(x, pos, theta, scaling=None):
    """Rotate-half RoPE on (L, H, D) at integer positions (L,). A
    ``scaling`` group of type ``yarn`` (DeepSeek-V2's) blends the plain
    frequencies with those divided by its factor over the dimensions its
    betas name, and scales cos and sin by mscale / mscale_all_dim's
    ratio; at factor 1 that is plain RoPE."""
    D = x.shape[-1]
    dev = x.device
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=dev) / D))
    m = 1.0
    if scaling is not None:
        assert scaling["type"] == "yarn", scaling
        f = scaling["factor"]
        orig = scaling["original_max_position_embeddings"]

        def dim_of(rot):
            return (D * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(theta)))
        lo = max(math.floor(dim_of(scaling["beta_fast"])), 0)
        hi = min(math.ceil(dim_of(scaling["beta_slow"])), D - 1)
        hi = hi + 0.001 if hi == lo else hi
        ramp = ((torch.arange(D // 2, dtype=torch.float32, device=dev) - lo)
                / (hi - lo)).clamp(0, 1)
        inter = 1.0 / (f * theta ** (torch.arange(
            0, D, 2, dtype=torch.float32, device=dev) / D))
        inv = inter * ramp + inv * (1 - ramp)
        m = (_yarn_mscale(f, scaling.get("mscale", 1))
             / _yarn_mscale(f, scaling.get("mscale_all_dim", 0)))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None] * m, torch.sin(ang)[:, None] * m
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1).to(x.dtype)


def _round(t, dtype):
    return t.to(dtype).to(t.dtype)


def _attend(q, k, v, scale, S, cache_dtype):
    """q (L, Hq, D), k (L, Hkv, D), v (L, Hkv, Dv), causal. Rows below S
    (the prompt) attend the keys as computed; the others keys and values
    rounded to ``cache_dtype``, probabilities and output rounded too."""
    L, Hq, _ = q.shape
    g = Hq // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()

    def part(rows, kk, vv, rounded):
        s = torch.einsum("qhd,khd->hqk", q[rows].float(), kk.float()) * scale
        s = s.masked_fill(~mask[rows][None], float("-inf"))
        p = torch.softmax(s, -1)
        if rounded:
            p = _round(p, cache_dtype)
        o = torch.einsum("hqk,khd->qhd", p, vv.float())
        return _round(o, cache_dtype) if rounded else o

    out = [part(slice(0, S), k, v, False)]
    if L > S:
        out.append(part(slice(S, L), _round(k, cache_dtype),
                        _round(v, cache_dtype), True))
    return torch.cat(out).to(q.dtype)


def _gqa(c, p, h, pos, S, cache_dtype):
    L = h.shape[0]
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or c["hidden_size"] // H
    q, k, v = ((h @ p[n]["w"] + p[n]["b"]) if "b" in p[n] else h @ p[n]["w"]
               for n in ("wq", "wk", "wv"))
    q = rope(q.reshape(L, H, D), pos, c["rope_theta"])
    k = rope(k.reshape(L, Hkv, D), pos, c["rope_theta"])
    o = _attend(q, k, v.reshape(L, Hkv, D), D ** -0.5, S, cache_dtype)
    return o.reshape(L, H * D) @ p["wo"]["w"]


def _mla(c, p, h, pos, S, cache_dtype):
    L = h.shape[0]
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    ys = c.get("rope_scaling")
    scale = (dn + dr) ** -0.5
    if ys and ys.get("mscale_all_dim"):
        scale *= _yarn_mscale(ys["factor"], ys["mscale_all_dim"]) ** 2
    q = (h @ p["wq"]["w"]).reshape(L, H, dn + dr)
    qn, qr = q[..., :dn], rope(q[..., dn:], pos, c["rope_theta"], ys)
    dkv = h @ p["wdkv"]["w"]
    ckv = rms(dkv[:, :r], p["ckv_norm"]["scale"], c["rms_norm_eps"])
    kr = rope(dkv[:, None, r:], pos, c["rope_theta"], ys)[:, 0]   # (L, dr)
    # the prompt: per-head keys and values expanded from the latent
    kn = torch.einsum("lr,rhn->lhn", ckv[:S], p["wuk"])
    v = torch.einsum("lr,rhv->lhv", ckv[:S], p["wuv"])
    k = torch.cat([kn, kr[:S, None].expand(S, H, dr)], -1)
    qs = torch.cat([qn[:S], qr[:S]], -1)
    out = [_attend(qs, k, v, scale, S, cache_dtype)]
    if L > S:
        # served positions: the latent and the roped key held in the cache
        # dtype, attention through the latent (W_uk into the query, W_uv
        # after the probabilities)
        cb, kb = _round(ckv, cache_dtype).float(), _round(kr, cache_dtype) \
            .float()
        qc = torch.einsum("lhn,rhn->lhr", qn[S:].float(), p["wuk"].float())
        s = (torch.einsum("lhr,tr->hlt", qc, cb)
             + torch.einsum("lhd,td->hlt", qr[S:].float(), kb)) * scale
        mask = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()[S:]
        s = s.masked_fill(~mask[None], float("-inf"))
        pr = _round(torch.softmax(s, -1), cache_dtype)
        oc = _round(torch.einsum("hlt,tr->lhr", pr, cb), cache_dtype)
        out.append(torch.einsum("lhr,rhv->lhv", oc.to(h.dtype), p["wuv"]))
    return torch.cat(out).reshape(L, H * dv) @ p["wo"]["w"]


def _mlp(c, p, h):
    if "w3" in p:
        return (F.silu(h @ p["w1"]["w"]) * (h @ p["w3"]["w"])) @ p["w2"]["w"]
    return F.gelu(h @ p["w1"]["w"], approximate="tanh") @ p["w2"]["w"]


def _capacity_keep(c, idx, S):
    """Which (token, k) assignments the configuration's per-call expert
    capacity keeps: the prompt is one call of S tokens, its assignments
    ranked per expert in (token, k) order, those ranked at or past
    max(int(S k / E cf), 8) dropped. A served token is a call of its own
    here (in the timed path it shares a decode step with the other slots,
    where it ranks first unless eight earlier slots chose the same
    expert), so it drops nothing."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    cf = c.get("moe_capacity_factor")
    if cf is None:
        return keep
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    cap = max(int(S * k / E * cf), 8)
    flat = idx[:S].reshape(-1)
    oh = F.one_hot(flat, E)
    rank = (torch.cumsum(oh, 0) - oh).gather(1, flat[:, None])[:, 0]
    keep[:S] = (rank < cap).reshape(S, k)
    return keep


def _moe(c, p, h, S, drops, margins):
    k = c["num_experts_per_tok"]
    probs = torch.softmax(h.float() @ p["router"]["w"].float(), -1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    margins.append(w[:, k - 1] - w[:, k])
    w, idx = w[:, :k], idx[:, :k]
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
    w = w * c["routed_scaling_factor"]
    keep = _capacity_keep(c, idx, S)
    drops.append(int((~keep).sum()))
    w = w * keep
    ex = p["experts"]
    y = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        x = h[rows]
        o = (F.silu(x @ ex["w1"][e]) * (x @ ex["w3"][e])) @ ex["w2"][e]
        y.index_add_(0, rows, o * w[rows, slot, None].to(h.dtype))
    return y + _mlp(c, p["shared"], h)


def _eps(c):
    return c.get("rms_norm_eps", c.get("norm_epsilon"))


@torch.no_grad()
def served_logits(c: dict, params: dict, prompt, served,
                  cache_dtype=torch.bfloat16, dtype=torch.float32,
                  drops: list = None, margins: list = None):
    """Logits (len(served), V) f32 predicting each served token after
    ``prompt`` (ids, BOS included). ``c`` is the configuration file's
    dict; ``params`` the benchmark's weights, cast to ``dtype``.
    ``drops`` gets each MoE layer's count of dropped assignments,
    ``margins`` each MoE layer's (L,) gap between the k-th and the next
    routing probability of every position."""
    drops = [] if drops is None else drops
    margins = [] if margins is None else margins
    dev = params["embed"]["w"].device
    ids = torch.tensor(list(prompt) + list(served)[:-1], device=dev)
    S, L = len(prompt), len(prompt) + len(served) - 1
    pos = torch.arange(L, device=dev)

    def cast(t):
        return t.to(dtype) if t.dtype != dtype else t

    x = cast(params["embed"]["w"][ids])
    mla = "kv_lora_rank" in c
    layers = [(b, "dense") for b in params.get("dense0", [])] + \
        [(b, "moe" if "moe" in b else "dense") for b in params["blocks"]]
    eps = _eps(c)
    for b, kind in layers:
        b = _tree(b, cast)
        h = rms(x, b["ln1"]["scale"], eps)
        x = x + (_mla if mla else _gqa)(c, b["attn"], h, pos, S, cache_dtype)
        h = rms(x, b["ln2"]["scale"], eps)
        x = x + (_moe(c, b["moe"], h, S, drops, margins) if kind == "moe"
                 else _mlp(c, b["mlp"], h))
    h = rms(x[S - 1:], cast(params["final_norm"]["scale"]), eps)
    return (h @ cast(params["lm_head"]["w"])).float()


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)
