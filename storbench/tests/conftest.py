"""The benchmark's own CPU tests (run them with ``PYTHONPATH=src python -m
pytest -q storbench/tests`` from the checkout's root): the traffic, the
readers, the roofline arithmetic, the import rule, and every cell run end
to end at a tiny size on the CPU, sound and with faults planted."""
import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (ROOT / "src", BENCH, BENCH / "traffic", BENCH / "reference"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny_config(name: str) -> dict:
    """The cell's configuration file with every size cut to a CPU's: the
    same keys, so the same code paths in the program and the reference."""
    c = copy.deepcopy(json.loads((BENCH / "configs" / f"{name}.json")
                                 .read_text()))
    if "kv_lora_rank" in c:
        c.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                 num_key_value_heads=4, vocab_size=1024,
                 intermediate_size=128, moe_intermediate_size=32,
                 n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    else:
        c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16, vocab_size=1024,
                 intermediate_size=128)
    c["system"] = dict(c["system"], store_rows=2000,
                       minilm=dict(dim=64, layers=2, heads=2, d_ff=128,
                                   embed_std=1.0))
    return c


def tiny_mix(name: str) -> dict:
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    m.update(clients=4, decode_slots=4, max_new_lo=8, max_new_hi=24,
             blocks_per_client=12)
    return m


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
