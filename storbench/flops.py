"""Model FLOPs of one decoded token, from the configuration file alone
(the benchmark's own arithmetic, for ``decode.step_mfu``).

A token costs 2 FLOPs per weight of every product it passes through
(attention projections, the MLP or the routed top-k and shared experts
with the router, the output head; not the embedding lookup) plus the
attention over the positions it attends: 2 (d_qk + d_v) per position and
query head, in the expanded form of the architecture (for MLA, per-head
keys of nope + rope width and values of ``v_head_dim``).

That arithmetic covers the two layouts ``reference/lm.py`` runs. A
configuration file that names a reference of its own (``"reference":
"<stem>"``, see ``cell``) is counted by that module's ``token_flops``.
"""
from __future__ import annotations


def _attn_weights(c: dict) -> int:
    d, H = c["hidden_size"], c["num_attention_heads"]
    if "kv_lora_rank" in c:
        r, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
        return (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv)
                + H * dv * d)
    hd = head_dim(c)
    return d * H * hd + 2 * d * c["num_key_value_heads"] * hd + H * hd * d


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def qk_v_width(c: dict):
    if "kv_lora_rank" in c:
        return c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]
    return head_dim(c), head_dim(c)


def active_weights(c: dict) -> int:
    """Weights one token multiplies through."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    total = L * _attn_weights(c) + d * c["vocab_size"]
    if "n_routed_experts" in c:
        dense = c["first_k_dense_replace"]
        ffe = c["moe_intermediate_size"]
        per_moe = (d * c["n_routed_experts"]
                   + (c["num_experts_per_tok"] + c["n_shared_experts"])
                   * 3 * d * ffe)
        return total + dense * 3 * d * c["intermediate_size"] \
            + (L - dense) * per_moe
    mlp = (3 if c.get("gated_mlp") else 2) * d * c["intermediate_size"]
    return total + L * mlp


def token_flops(c: dict, attended: int) -> float:
    """FLOPs of one token that attends ``attended`` positions."""
    if c.get("reference", "lm") != "lm":
        import cell   # the loader; cell imports this module at its top
        return cell.reference(c).token_flops(c, attended)
    dqk, dv = qk_v_width(c)
    return 2.0 * active_weights(c) + 2.0 * c["num_hidden_layers"] \
        * attended * c["num_attention_heads"] * (dqk + dv)
