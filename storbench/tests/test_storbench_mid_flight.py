"""The reader of ``admission.mid_flight_share`` on a synthetic span list:
spans inside and outside the window, wave admission (all false), spans
without the attribute (an older program), no trace, and a program without
the recorder."""
import importlib.util
import sys
import types

import pytest

import spans as SP
from conftest import BENCH
from repro_torch import trace
from repro_torch.trace import Span


def read(c):
    spec = importlib.util.spec_from_file_location(
        "m_admission_mid_flight_share",
        BENCH / "metrics" / "admission.mid_flight_share.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.read(c)


def prefill(t0, t1, rid, **attrs):
    return Span("admission.prefill", t0, t1, t1 - t0, "d", rid=rid,
                attrs=dict(prompt_len=5, **attrs))


# window [0, 10]: the first and the last span end outside it
SPANS = [
    prefill(-1.0, -0.5, 0, mid_flight=True),
    prefill(0.5, 0.6, 1, mid_flight=False),
    prefill(2.0, 2.1, 2, mid_flight=True),
    prefill(4.0, 4.2, 3, mid_flight=True),
    prefill(6.0, 6.1, 4, mid_flight=False),
    prefill(9.9, 10.2, 5, mid_flight=False),
    Span("decode.queue", 1.0, 2.0, None, "d", rid=2),
]


def ctx(traced=True):
    t = SP.Trace(window_s=10.0, busy_s=9.0, ops={}, kernels={}, least={},
                 gaps=[]) if traced else None
    win = types.SimpleNamespace(t0=0.0, t1=10.0, trace=t)
    return SP.Context(cfg={}, mix={}, rec=SP.Spans(), win=win, setup_s=1.0)


@pytest.fixture
def spans(monkeypatch):
    log = list(SPANS)
    monkeypatch.setattr(trace, "spans", lambda: list(log))
    return log


def test_share_of_the_admissions_inside_the_window(spans):
    assert read(ctx()) == pytest.approx(100.0 * 2 / 4)


def test_wave_admission_reads_zero(spans):
    spans[:] = [prefill(s.t0, s.t1, s.rid, mid_flight=False)
                for s in SPANS if s.name == "admission.prefill"]
    assert read(ctx()) == 0.0


def test_spans_without_the_attribute_are_not_counted(spans):
    spans.append(prefill(3.0, 3.1, 6))             # an older program's span
    assert read(ctx()) == pytest.approx(100.0 * 2 / 4)
    spans[:] = [prefill(s.t0, s.t1, s.rid) for s in SPANS
                if s.name == "admission.prefill"]
    assert read(ctx()) is None


def test_nothing_to_read_gives_no_value(spans):
    assert read(ctx(traced=False)) is None
    spans[:] = [s for s in SPANS if s.t1 > 10.0 or s.t1 < 0.0]
    assert read(ctx()) is None
    spans.clear()
    assert read(ctx()) is None


def test_a_program_without_the_recorder_gives_no_value(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read(ctx()) is None
