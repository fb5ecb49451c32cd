"""The port's span recorder (``repro_torch.trace``) on the CPU: it records
nothing while off, and records under a ``torch.profiler`` session or
``enable()``; a stream through ``StorInfer.submit`` leaves the five
serving spans, a miss's spans share its ``rid``, the chunks' token counts
add up to each request's tokens, greedy answers do not change with
tracing on, and the buffer's bound counts what it drops. No timing is
asserted."""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.api import EngineCfg, StorInfer, SystemCfg
from repro_torch.core.kb import build_kb, sample_user_queries
from repro_torch.serving.engine import BatchScheduler, Request

MAX_NEW = 8
SERVING = ("search.batch", "decode.queue", "admission.prefill",
           "decode.chunk", "decode.step")


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.disable()
    trace.clear()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    kb = build_kb("squad", n_docs=8)
    cfg = SystemCfg(index="flat", device="cpu",
                    engine=EngineCfg(smoke=True, max_len=64, chunk=4))
    si = StorInfer.build(kb, cfg, tmp_path_factory.mktemp("trace") / "st",
                         n_pairs=120)
    stored = [si.store.get_pair(r)[0] for r in (0, 7, 31)]
    users = [q for q, _ in sample_user_queries(kb, 8, seed=3)]
    yield si, stored + users + ["zebra xylophone never stored anywhere"]
    si.close()


@contextlib.contextmanager
def recording(how):
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            yield
    elif how == "enable":
        trace.enable()
        try:
            yield
        finally:
            trace.disable()
    else:
        yield


def serve(si, texts):
    with si.serve():
        futs = [si.submit(t, max_new=MAX_NEW) for t in texts]
        return [f.result(timeout=300) for f in futs]


def schedule(engine, max_news, cancel=None):
    sched = BatchScheduler(engine, batch_size=2)
    reqs = [Request(rid=10 + i, prompt=f"what is item {i} of the list",
                    max_new=n) for i, n in enumerate(max_news)]
    for r in reqs:
        sched.submit(r)
    if cancel is not None:
        sched.step_chunk()
        sched.cancel(reqs[cancel].rid)
    sched.run_to_completion()
    return reqs


def by_name(name):
    return [s for s in trace.spans() if s.name == name]


def test_nothing_is_recorded_when_off(system):
    si, texts = system
    assert trace.start() is None and trace.now() is None
    schedule(si.engine, [5, 9])
    serve(si, texts[:4])
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_spans_are_recorded_when_on(system, how):
    si, _ = system
    with recording(how):
        assert trace.start() is not None
        schedule(si.engine, [5, 9, 3])
    assert trace.clock_offset_ns() is not None
    names = {s.name for s in trace.spans()}
    assert names == {"decode.queue", "admission.prefill", "decode.chunk",
                     "decode.step"}
    for s in trace.spans():
        assert s.t0 <= s.t1
        if s.name == "decode.queue":          # its ends are stamped apart
            assert s.cpu_s is None
        else:
            assert s.cpu_s is not None and s.cpu_s >= 0
    assert {s.rid for s in by_name("decode.queue")} == \
        {s.rid for s in by_name("admission.prefill")} == {10, 11, 12}
    assert all(s.attrs["prompt_len"] > 0
               for s in by_name("admission.prefill"))
    assert all(s.attrs["slots"] == 2 and s.attrs["steps"] == 4
               for s in by_name("decode.chunk"))
    # one decode.step per step of each chunk, at rising cache lengths
    steps = by_name("decode.step")
    assert len(steps) == 4 * len(by_name("decode.chunk"))
    lens = [s.attrs["cache_len"] for s in steps]
    assert all(b == a + 1 for a, b in zip(lens[0::4], lens[1::4]))


@pytest.mark.parametrize("max_news,cancel", [([5, 9, 3], None),
                                             ([1, 12, 7, 4], 1)],
                         ids=["finished", "cancelled"])
def test_chunk_tokens_add_up_to_each_request(system, max_news, cancel):
    si, _ = system
    with recording("enable"):
        reqs = schedule(si.engine, max_news, cancel)
    kept = {}
    for s in by_name("decode.chunk"):
        assert sum(s.attrs["tokens"].values()) <= \
            s.attrs["slots"] * s.attrs["steps"]
        for rid, n in s.attrs["tokens"].items():
            kept[rid] = kept.get(rid, 0) + n
    for r in reqs:
        assert r.done
        assert kept.get(r.rid, 0) == len(r.out_ids) - 1


def test_a_stream_leaves_every_span_under_one_rid(system):
    si, texts = system
    with recording("enable"):
        results = serve(si, texts)
    misses = [r for r in results if not r.hit]
    assert misses and len(misses) < len(results)
    names = {s.name for s in trace.spans()}
    assert set(SERVING) <= names
    searched = [rid for s in by_name("search.batch") for rid in s.rids]
    assert sorted(searched) == sorted(set(searched))
    assert sum(s.attrs["n"] for s in by_name("search.batch")) == len(texts)
    assert all(s.thread == "pipeline-search"
               for s in by_name("search.batch"))
    queued = [s.rid for s in by_name("decode.queue")]
    assert len(queued) == len(set(queued)) == len(misses)
    assert set(queued) <= set(searched)
    assert {s.rid for s in by_name("admission.prefill")} == set(queued)
    chunk_rids = {rid for s in by_name("decode.chunk")
                  for rid in s.attrs["tokens"]}
    assert chunk_rids <= set(queued)
    assert sum(sum(s.attrs["tokens"].values())
               for s in by_name("decode.chunk")) == \
        sum(r.tokens - 1 for r in misses)
    for name in ("search.batch", "admission.prefill", "decode.chunk",
                 "decode.step"):
        assert all(s.cpu_s is not None for s in by_name(name))
    snap = si.stats().pipeline
    assert "hit" not in snap and "miss" not in snap


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_greedy_answers_do_not_change_with_tracing(system, how):
    si, texts = system
    off = serve(si, texts)
    with recording(how):
        on = serve(si, texts)
    assert trace.spans()
    assert [(r.hit, r.response, r.tokens) for r in on] == \
        [(r.hit, r.response, r.tokens) for r in off]


def test_the_buffer_bound_counts_drops():
    rec = trace.Recorder(limit=3)
    assert rec.start() is None
    rec.enable()
    for i in range(5):
        rec.end(rec.start(), "x", rid=i)
    rec.add("y", 0.0, 1.0)
    assert [s.rid for s in rec.spans()] == [0, 1, 2]
    assert rec.dropped() == 3
    rec.clear()
    assert rec.spans() == [] and rec.dropped() == 0
    rec.disable()
    assert rec.start() is None
