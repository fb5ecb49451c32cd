"""The reference's RoPE reads the configuration's YaRN group as
DeepSeek-V2 defines it: at factor 1 it is plain RoPE with the plain
softmax scale, at the source's factor 40 it is not."""
import json
import math

import torch

import lm
from conftest import BENCH


def _deepseek():
    return json.loads((BENCH / "configs" /
                       "deepseek-v2-lite-16b-fp32.json").read_text())


def _transcribed_yarn(x, pos, theta, g):
    """DeepSeek-V2's YaRN rotary embedding, written out step by step."""
    D = x.shape[-1]

    def dim_of(rot):
        return (D * math.log(g["original_max_position_embeddings"]
                             / (rot * 2 * math.pi)) / (2 * math.log(theta)))
    lo = max(math.floor(dim_of(g["beta_fast"])), 0)
    hi = min(math.ceil(dim_of(g["beta_slow"])), D - 1)
    base = theta ** (torch.arange(0, D, 2).float() / D)
    extra, inter = 1.0 / base, 1.0 / (g["factor"] * base)
    keep = 1.0 - ((torch.arange(D // 2).float() - lo) / (hi - lo)).clamp(0, 1)
    inv = inter * (1 - keep) + extra * keep
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def test_factor_one_is_plain_rope():
    c = _deepseek()
    assert c["rope_scaling"]["factor"] == 1
    x = torch.randn(160, 4, c["qk_rope_head_dim"],
                    generator=torch.Generator().manual_seed(0))
    pos = torch.arange(160)
    plain = lm.rope(x, pos, c["rope_theta"])
    assert torch.equal(lm.rope(x, pos, c["rope_theta"], c["rope_scaling"]),
                       plain)
    assert lm._yarn_mscale(1, c["rope_scaling"]["mscale_all_dim"]) == 1.0


def test_source_factor_is_yarn():
    c = _deepseek()
    g = dict(c["rope_scaling"], factor=40)
    x = torch.randn(160, 4, c["qk_rope_head_dim"],
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(160)
    got = lm.rope(x, pos, c["rope_theta"], g)
    assert torch.allclose(got, _transcribed_yarn(x, pos, c["rope_theta"], g),
                          atol=1e-5)
    assert not torch.allclose(got, lm.rope(x, pos, c["rope_theta"]),
                              atol=1e-2)
    assert lm._yarn_mscale(40, 0.707) ** 2 == \
        (0.1 * 0.707 * math.log(40) + 1) ** 2
