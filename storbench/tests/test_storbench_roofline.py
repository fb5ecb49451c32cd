"""The copied least-time arithmetic against the bound ms of PERF.md §6's
kernel table (B1, B3, B4 at phase 3's shapes), and the model FLOPs."""
import pytest

import flops
import roofline


def test_b1_bound_is_the_tables():
    ms = roofline.mips_topk_s(32, 150000, 384, 1, 512, "float32",
                              "float16") * 1e3
    assert ms == pytest.approx(0.0344, abs=5e-5)


def test_b3_bound_is_the_tables():
    ms = roofline.decode_attention_s(4, 16, 128, 160, 8, 128, 4 * 101,
                                     "float32", "bfloat16") * 1e3
    assert ms == pytest.approx(0.00051, abs=5e-6)


@pytest.mark.parametrize("B,S,Hq,D,Hkv,causal,want", [
    (256, 64, 6, 64, 6, False, 0.0300),
    (1, 160, 16, 128, 8, True, 0.00117),
    (1, 46, 16, 128, 8, True, 0.00034),
    (1, 512, 16, 128, 8, True, 0.00652),
])
def test_b4_bound_is_the_tables(B, S, Hq, D, Hkv, causal, want):
    ms = roofline.flash_attention_s(B, S, Hq, D, S, Hkv, D, causal,
                                    "float32") * 1e3
    assert ms == pytest.approx(want, rel=0.02)


def test_token_flops_count_the_active_weights():
    import json
    from conftest import BENCH
    ds = json.loads((BENCH / "configs" /
                     "deepseek-v2-lite-16b-fp32.json").read_text())
    sc = json.loads((BENCH / "configs" / "starcoder2-7b-fp32.json")
                    .read_text())
    # 2.4 B active (DeepSeek-V2-Lite's card) plus the output head
    assert 2.4e9 < flops.active_weights(ds) < 2.9e9
    assert 7.0e9 < flops.active_weights(sc) < 7.4e9
    assert flops.token_flops(sc, 100) - flops.token_flops(sc, 0) == \
        2 * 32 * 100 * 36 * 256
