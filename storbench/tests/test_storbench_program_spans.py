"""The readers of the program's own spans (``repro_torch.trace``) on a
synthetic span list and gap list: spans that straddle the window's
edges, no spans, no trace, and a program without the recorder."""
import importlib.util
import sys
import types

import pytest

import program_spans as PS
import spans as SP
from conftest import BENCH
from repro_torch import trace
from repro_torch.trace import Span

READERS = ["admission.slot_wait_ms", "admission.prefill_ms",
           "decode.slot_yield", "decode.dispatch_idle", "decode.off_cpu_ms",
           "search.off_cpu_ms"]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.read


def chunk(t0, t1, tokens):
    return Span("decode.chunk", t0, t1, 0.0, "d",
                attrs={"slots": 4, "steps": 8, "tokens": tokens})


# window [0, 10]; the last span of each name ends past it
SPANS = [
    Span("decode.queue", -1.0, 1.0, None, "d", rid=1),
    Span("decode.queue", 2.0, 3.0, None, "d", rid=2),
    Span("decode.queue", 9.0, 11.0, None, "d", rid=3),
    Span("admission.prefill", 0.5, 0.6, 0.1, "d", rid=1,
         attrs={"prompt_len": 5}),
    Span("admission.prefill", 4.0, 4.3, 0.3, "d", rid=2,
         attrs={"prompt_len": 5}),
    Span("admission.prefill", 10.0, 10.2, 0.2, "d", rid=3,
         attrs={"prompt_len": 5}),
    chunk(1.0, 2.0, {1: 8, 2: 3}),
    chunk(5.0, 6.0, {1: 2}),
    chunk(9.5, 10.5, {1: 8, 2: 8, 3: 8, 4: 8}),
    Span("decode.step", 1.0, 1.5, 0.3, "d", attrs={"cache_len": 4}),
    Span("decode.step", 1.5, 2.0, 0.5, "d", attrs={"cache_len": 5}),
    Span("decode.step", 9.9, 10.1, 0.0, "d", attrs={"cache_len": 6}),
    Span("search.batch", 0.2, 0.4, 0.05, "s", rids=(1, 5), attrs={"n": 2}),
    Span("search.batch", 3.0, 3.5, 0.5, "s", rids=(6,), attrs={"n": 1}),
    Span("search.batch", 9.8, 10.3, 0.0, "s", rids=(7,), attrs={"n": 1}),
]
GAPS = [(0.0, 0.3), (1.2, 1.8), (3.2, 3.4), (7.0, 8.0)]


def ctx(traced=True):
    t = SP.Trace(window_s=10.0, busy_s=10.0 - 2.1, ops={}, kernels={},
                 least={}, gaps=list(GAPS)) if traced else None
    win = types.SimpleNamespace(t0=0.0, t1=10.0, trace=t)
    return SP.Context(cfg={}, mix={}, rec=SP.Spans(), win=win, setup_s=1.0)


@pytest.fixture
def spans(monkeypatch):
    log = list(SPANS)
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    return log


@pytest.mark.parametrize("name,value", [
    ("admission.slot_wait_ms", 1500.0),      # 2 s and 1 s
    ("admission.prefill_ms", 200.0),         # 0.1 s and 0.3 s
    ("decode.slot_yield", 100.0 * 13 / 64),  # 13 tokens, 2 x 4 x 8 rows
    ("decode.dispatch_idle", 6.0),           # (1.2, 1.8) inside the steps
    ("decode.off_cpu_ms", 100.0),            # 0.2 s and 0 s
    ("search.off_cpu_ms", 75.0),             # 0.15 s and 0 s
])
def test_known_answer(spans, name, value):
    assert reader(name)(ctx()) == pytest.approx(value)


def test_the_idle_split_adds_up_to_the_idle_time(spans):
    c = ctx()
    split = PS.idle_split(c)
    assert split == pytest.approx({"decode.step": 0.6, "decode.chunk": 0.0,
                                   "admission.prefill": 0.0,
                                   "search.batch": 0.3, "none": 1.2})
    assert sum(split.values()) == pytest.approx(
        c.win.trace.window_s - c.win.trace.busy_s)
    reader("decode.dispatch_idle")(c)
    assert c.notes == ["device idle by host span: decode.step 6.000%, "
                       "rest of decode.chunk 0.000%, admission.prefill "
                       "0.000%, search.batch 3.000%, none 12.000%"]


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_no_value(spans, monkeypatch, name):
    assert reader(name)(ctx(traced=False)) is None
    spans.clear()
    assert reader(name)(ctx()) is None
    # a span list with only spans outside the window
    spans.extend(s for s in SPANS if s.t1 > 10.0)
    assert reader(name)(ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_gives_no_value(monkeypatch, name):
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert reader(name)(ctx()) is None


@pytest.mark.parametrize("xs,ys,both,only_x", [
    ([(0, 4)], [(1, 2), (3, 5)], [(1, 2), (3, 4)], [(0, 1), (2, 3)]),
    ([(0, 1), (2, 3)], [(1, 2)], [], [(0, 1), (2, 3)]),
    ([(0, 10)], [(-1, 11)], [(0, 10)], []),
    ([(0, 1), (5, 6)], [], [], [(0, 1), (5, 6)]),
])
def test_interval_arithmetic(xs, ys, both, only_x):
    assert PS.intersect(xs, ys) == both
    assert PS.subtract(xs, ys) == only_x
    assert PS.merged([(3, 5), (0, 1), (1, 2), (4, 6), (7, 7)]) == \
        [(0, 2), (3, 6)]
