"""Plain PyTorch forward pass of a Nemotron-H layer pattern
(NVIDIA-Nemotron-3-Nano-30B-A3B), the reference the benchmark holds each
miss's logits to, with its FLOP count and its keys on the port's config.

The stack, as the published modelling code runs it: the token embedding,
then one block per letter of ``hybrid_override_pattern``, each
``x + mixer(rms(x))``, then a final RMS norm and an untied head. The
mixers:

* ``M``, Mamba-2: one input projection to the gate z, the convolved
  inputs (x, B, C) and the step dt of each head; a depthwise causal
  convolution of ``conv_kernel`` taps with bias, then SiLU; per head
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T`` and ``y_t = h_t C_t +
  D x_t`` with dt = softplus(dt + dt_bias), A = -exp(A_log), B and C
  shared by the heads of a group; y times SiLU(z), RMS-normed over each
  of ``n_groups`` groups of channels on its own, scaled, projected out.
  The recurrence runs token by token here (the program runs it chunked).
* ``E``, MoE: sigmoid scores of a router over every routed expert of the
  layer; the top ``num_experts_per_tok`` chosen by score plus the
  router's correction bias (one group of experts: ``n_group`` and
  ``topk_group`` are 1), weighed by their scores renormalised and times
  ``routed_scaling_factor``; experts and the shared expert are
  ``down(relu(up x)^2)``. Where the configuration holds a share of the
  experts (``n_routed_experts`` of ``published_n_routed_experts``, from
  ``first_held_expert``), only the held experts' assignments are
  computed, with the weights the whole top-k gave them.
* ``*``, GQA attention with no bias and no rotary embedding (the
  published code applies none), scale 1/sqrt(head_dim).

One call runs the prompt, then every served token but the last, and
returns the logits that predict each served token, under
``reference/lm.py``'s contract: the prompt's positions are one full pass
in f32; a served position reads what the timed path keeps in its cache:
keys and values rounded to ``cache_dtype`` (attention probabilities and
output rounded too, ``lm._attend``), the convolution's earlier inputs
rounded to it, and the SSM state in f32. Everything else is f32 with
TF32 off, unless ``dtype`` (the control) asks for another precision; the
control's weights are cast one block, or one expert, at a time as they
are used. The weights are the benchmark's tensors, in the layout the
port's ``init_model`` gives; nothing here comes from the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import lm

# file key -> the port's ModelConfig field, beside ``cell.PORT_FIELDS``
PORT_FIELDS = {
    "mamba_num_heads": "ssm_heads", "mamba_head_dim": "ssm_head_dim",
    "n_groups": "ssm_n_groups", "ssm_state_size": "ssm_state",
    "conv_kernel": "ssm_conv", "chunk_size": "ssm_chunk",
    "hybrid_override_pattern": "layer_pattern",
    "moe_shared_expert_intermediate_size": "d_ff_shared",
    "routed_scaling_factor": "routed_scale",
    "published_n_routed_experts": "router_experts",
    "first_held_expert": "first_expert",
    "mlp_hidden_act": "mlp_act",
    "layer_norm_epsilon": "norm_eps", "norm_eps": "norm_eps",
}

# what the forward pass below computes; a file stating otherwise stops it
_STATED = {"attention_bias": False, "mlp_bias": False,
           "mamba_proj_bias": False, "use_conv_bias": True,
           "mamba_hidden_act": "silu", "mlp_hidden_act": "relu2",
           "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
           "tie_word_embeddings": False, "residual_in_fp32": False}


def _checked(c: dict) -> dict:
    for k, v in _STATED.items():
        if c.get(k) != v:
            raise ValueError(f"{c.get('name')}: {k} is {c.get(k)!r}; the "
                             f"reference computes {v!r}")
    if len(c["hybrid_override_pattern"]) != c["num_hidden_layers"]:
        raise ValueError("hybrid_override_pattern must have a letter per "
                         "layer")
    return c


def _relu2(x):
    return torch.square(F.relu(x))


def _mamba(c, p, h, S, cache_dtype):
    L = h.shape[0]
    H, P = c["mamba_num_heads"], c["mamba_head_dim"]
    G, N, W = c["n_groups"], c["ssm_state_size"], c["conv_kernel"]
    di = H * P
    zxbcdt = h @ p["in_proj"]["w"]
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * G * N], \
        zxbcdt[:, 2 * di + 2 * G * N:]
    # the causal convolution: position t reads inputs t-W+1..t; a served
    # position reads its earlier ones from the cache, rounded
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    held = F.pad(lm._round(xbc, cache_dtype), (0, 0, W - 1, 0))
    conv = torch.stack([
        ((pad if t < S else held)[t:t + W - 1] * p["conv_w"][:W - 1]).sum(0)
        + xbc[t] * p["conv_w"][W - 1] for t in range(L)])
    xbc = F.silu(conv + p["conv_b"])
    xs = xbc[:, :di].reshape(L, H, P).float()
    Bm = xbc[:, di:di + G * N].reshape(L, G, N).float()
    Cm = xbc[:, di + G * N:].reshape(L, G, N).float()
    Bm, Cm = (t.repeat_interleave(H // G, 1) for t in (Bm, Cm))
    dt = F.softplus(dt.float() + p["dt_bias"].float())            # (L, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"].float()))
    state = torch.zeros(H, P, N, dtype=torch.float32, device=h.device)
    ys = []
    for t in range(L):
        state = state * decay[t, :, None, None] + \
            (dt[t, :, None] * xs[t])[:, :, None] * Bm[t, :, None, :]
        ys.append(torch.einsum("hpn,hn->hp", state, Cm[t]))
    y = torch.stack(ys) + xs * p["D"].float()[:, None]
    g = (y.reshape(L, di) * F.silu(z.float())).reshape(L, G, di // G)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + _eps(c))
    y = g.reshape(L, di).to(h.dtype) * p["norm"]["scale"]
    return y @ p["out_proj"]["w"]


def _moe(c, p, h, S, drops, margins, cast):
    k = c["num_experts_per_tok"]
    first, E = c.get("first_held_expert", 0), c["n_routed_experts"]
    width = c.get("published_n_routed_experts", E)
    r = p["router"]
    scores = torch.sigmoid(h.float() @ r["w"].float())
    choice, idx = torch.sort(scores + r["bias"].float(), dim=-1,
                             descending=True, stable=True)
    margins.append(choice[:, k - 1] - choice[:, k])
    idx = idx[:, :k]
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    keep = (idx >= first) & (idx < first + E)
    # the configuration's per-call capacity, max(int(S k / width cf), 8)
    # assignments a held expert, over the prompt in (token, k) order
    cf = c.get("moe_capacity_factor")
    if cf is not None:
        cap = max(int(S * k / width * cf), 8)
        mine = keep[:S].reshape(-1)
        local = torch.where(mine, idx[:S].reshape(-1) - first, 0)
        oh = F.one_hot(local, E) * mine[:, None]
        rank = (torch.cumsum(oh, 0) - oh).gather(1, local[:, None])[:, 0]
        over = keep[:S] & (rank.reshape(S, k) >= cap)
        drops.append(int(over.sum()))
        keep[:S] &= ~over
    ex = p["experts"]
    y = torch.zeros_like(h)
    for e in torch.unique(idx[keep]).tolist():
        rows, slot = ((idx == e) & keep).nonzero(as_tuple=True)
        x = h[rows]
        o = _relu2(x @ cast(ex["w1"][e - first])) @ cast(ex["w2"][e - first])
        y.index_add_(0, rows, o * w[rows, slot, None].to(h.dtype))
    s = p["shared"]
    return y + _relu2(h @ cast(s["w1"]["w"])) @ cast(s["w2"]["w"])


def _attention(c, p, h, S, cache_dtype):
    L = h.shape[0]
    H, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    q, kk, v = (h @ p[n]["w"] for n in ("wq", "wk", "wv"))
    o = lm._attend(q.reshape(L, H, D), kk.reshape(L, Hkv, D),
                   v.reshape(L, Hkv, D), D ** -0.5, S, cache_dtype)
    return o.reshape(L, H * D) @ p["wo"]["w"]


def _eps(c):
    return c.get("layer_norm_epsilon", c.get("norm_eps"))


@torch.no_grad()
def served_logits(c: dict, params: dict, prompt, served,
                  cache_dtype=torch.bfloat16, dtype=torch.float32,
                  drops: list = None, margins: list = None):
    """Logits (len(served), V) f32 predicting each served token after
    ``prompt`` (ids, BOS included). ``c`` is the configuration file's
    dict; ``params`` the benchmark's weights, cast to ``dtype`` as they
    are used. ``drops`` gets each MoE layer's count of held assignments
    past the capacity, ``margins`` each MoE layer's (L,) gap between the
    k-th and the next choice score of every position."""
    _checked(c)
    drops = [] if drops is None else drops
    margins = [] if margins is None else margins
    dev = params["embed"]["w"].device
    ids = torch.tensor(list(prompt) + list(served)[:-1], device=dev)
    S = len(prompt)

    def cast(t):
        return t.to(dtype) if t.dtype != dtype else t

    x = cast(params["embed"]["w"][ids])
    eps = _eps(c)
    for b, kind in zip(params["blocks"], c["hybrid_override_pattern"]):
        h = lm.rms(x, cast(b["ln"]["scale"]), eps)
        if kind == "M":
            x = x + _mamba(c, lm._tree(b["ssm"], cast), h, S, cache_dtype)
        elif kind == "E":
            x = x + _moe(c, b["moe"], h, S, drops, margins, cast)
        elif kind == "*":
            x = x + _attention(c, lm._tree(b["attn"], cast), h, S,
                               cache_dtype)
        else:
            raise ValueError(f"layer kind {kind!r}")
    h = lm.rms(x[S - 1:], cast(params["final_norm"]["scale"]), eps)
    return (h @ cast(params["lm_head"]["w"])).float()


def token_flops(c: dict, attended: int) -> float:
    """FLOPs of one decoded token that attends ``attended`` positions: 2
    per weight it multiplies through (the Mamba projections and
    convolution taps, the attention projections, the router, the shared
    expert, the held share of its top-k routed experts, k x held / router
    width of them, and the head), 5 per SSM state element (decay, the
    input's outer product and the sum; the read-out's product and sum),
    and 2 (d_qk + d_v) per attended position and query head in the
    attention layers."""
    d, pat = c["hidden_size"], c["hybrid_override_pattern"]
    H, P = c["mamba_num_heads"], c["mamba_head_dim"]
    G, N, W = c["n_groups"], c["ssm_state_size"], c["conv_kernel"]
    di = H * P
    mamba = d * (2 * di + 2 * G * N + H) + (di + 2 * G * N) * W + di * d
    Hq, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    attn = d * Hq * D + 2 * d * Hkv * D + Hq * D * d
    width = c.get("published_n_routed_experts", c["n_routed_experts"])
    routed = c["num_experts_per_tok"] * c["n_routed_experts"] / width
    moe = (d * width + routed * 2 * d * c["moe_intermediate_size"]
           + 2 * d * c["moe_shared_expert_intermediate_size"])
    n = {k: pat.count(k) for k in "ME*"}
    weights = n["M"] * mamba + n["*"] * attn + n["E"] * moe \
        + d * c["vocab_size"]
    return 2.0 * weights + 5.0 * n["M"] * H * P * N \
        + 2.0 * n["*"] * attended * Hq * 2 * D
