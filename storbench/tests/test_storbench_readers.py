"""Each reader's arithmetic on a synthetic span log."""
import importlib.util
import types

import pytest

import spans as SP
from conftest import BENCH


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.read


def ctx(trace=None):
    rec = SP.Spans()
    # window [0, 10]; chunks of 8 steps: one straddles the start, one the
    # end, one lies inside
    rec.chunks = [
        SP.Chunk(-1.0, 1.0, 0.0, 0, 16, 2, 8, 20, [8, 8]),
        SP.Chunk(2.0, 4.0, 0.5, 1, 17, 2, 8, 30, [8, 8]),
        SP.Chunk(9.0, 11.0, 0.0, 0, 8, 1, 8, 40, [8]),
        SP.Chunk(5.0, 5.1, 0.1, 1, 1, 0, 0, 0, []),
    ]
    rec.searches = [SP.Search(1.0, 1.01, ["a"], None, None, None),
                    SP.Search(3.0, 3.03, ["b", "c"], None, None, None),
                    SP.Search(10.5, 10.6, ["d"], None, None, None)]
    hit = types.SimpleNamespace(hit=True)
    miss = types.SimpleNamespace(hit=False)
    win = types.SimpleNamespace(
        t0=0.0, t1=10.0,
        done=[(None, 1.0, 1.02, hit), (None, 2.0, 2.04, hit),
              (None, 0.0, 4.0, miss), (None, 9.0, 11.0, miss),
              (None, 5.0, 5.5, RuntimeError())],
        stage0={"search": (10, 1.0)}, stage1={"search": (30, 1.2)},
        trace=trace)
    cfg = {"hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 128, "vocab_size": 100,
           "system": {"store_rows": 1000,
                      "minilm": {"dim": 8, "layers": 1, "d_ff": 16}}}
    return SP.Context(cfg=cfg, mix={}, rec=rec, win=win, setup_s=12.5)


def test_tokens_per_s_prorates_the_edge_chunks():
    # 16 * 0.5 + 17 + 8 * 0.5 + 1 = 30 tokens over 10 s
    assert reader("tokens_per_s")(ctx()) == pytest.approx(3.0)


def test_effective_latency_is_the_mean_over_answered_requests():
    # answered inside the window: 20 ms, 40 ms, 4000 ms
    assert reader("effective_latency_ms")(ctx()) == pytest.approx(
        (20 + 40 + 4000) / 3)


def test_setup_and_search_wait():
    c = ctx()
    assert reader("setup_s")(c) == 12.5
    assert reader("pipeline.search_wait_ms")(c) == pytest.approx(10.0)


def test_search_readers():
    c = ctx()
    assert reader("search.batch_ms")(c) == pytest.approx(20.0)
    assert reader("hit_p95_ms")(c) == pytest.approx(39.0)
    # per query: 64 positions x (2 (4*64 + 2*128) + 4*64*8) + 2*1000*8
    per_query = 64 * (2 * (4 * 64 + 2 * 128) + 4 * 64 * 8) + 2 * 1000 * 8
    assert reader("search.step_mfu")(c) == pytest.approx(
        100 * 3 * per_query / (0.04 * 67e12))


def test_decode_readers():
    c = ctx()
    # decode chunks: shares 0.5, 1, 0.5 of 8 steps -> 16 steps
    assert reader("decode.live_slots")(c) == pytest.approx(
        (2 * 4 + 2 * 8 + 1 * 4) / 16)
    busy = 2.0 * 0.5 + 1.5 + 2.0 * 0.5
    assert reader("decode.step_ms")(c) == pytest.approx(1e3 * busy / 16)
    assert 0 < reader("decode.step_mfu")(c) < 1e-3


def test_trace_readers():
    t = SP.Trace(window_s=4.0, busy_s=1.0, ops={},
                 kernels={"flash_attention": (10, 0.02),
                          "decode_attention": (0, 0.0),
                          "mips_topk": (4, 0.004)},
                 least={"flash_attention": (10, 0.001),
                        "decode_attention": (0, 0.0),
                        "mips_topk": (4, 0.002)}, gaps=[])
    c = ctx(trace=t)
    assert reader("device.idle")(c) == pytest.approx(75.0)
    assert reader("flash_attention_roofline")(c) == pytest.approx(5.0)
    assert reader("mips_topk_roofline")(c) == pytest.approx(50.0)
    # nothing to read: no value, never 0
    assert reader("decode_attention_roofline")(c) is None
    assert reader("mips_topk_roofline")(ctx()) is None
    assert reader("device.idle")(ctx()) is None
