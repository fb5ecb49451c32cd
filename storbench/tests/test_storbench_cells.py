"""Every cell end to end on the CPU at a tiny size (the program's plain
kernel paths, the reference, the checks, the contract's last line), and
the timed path broken underneath: ``correct`` has to come out false."""
import json

import pytest

import run
from conftest import BENCH, BENCHMARK, CELLS, run_cell

# what a CPU run cannot read: the card's trace, and the program's own
# spans, which it records only while the profiler traces the card
NEEDS_TRACE = {m["name"] for m in BENCHMARK["per_layer"]
               if m["source"] == "device_trace"
               or "program_spans" in (BENCH / "metrics" / f"{m['name']}.py")
               .read_text()}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "per_layer"])
def test_cell_runs_and_is_correct(bench, workload, trace, capsys):
    result, notes = run_cell(bench, workload, trace)
    run.emit(result, notes)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] and line["failed"] == 0 and line["attempted"]
    assert err.strip().splitlines()[-1].startswith("check ")
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}
    got = set(line["metrics"])
    assert got <= want
    # the trace's readings need the card; the rest is read on the CPU
    assert want - got <= NEEDS_TRACE


def _alter_tokens(si):
    e = si.engine
    orig = e._decode_chunk

    def bad(*a, **k):
        token, cache, n, toks = orig(*a, **k)
        toks = toks.clone()
        toks[:, -1] = (toks[:, -1] + 1) % 512
        return token, cache, n, toks
    e._decode_chunk = bad


def _alter_answers(si):
    get = si.store.get_pair
    si.store.get_pair = lambda row: (get(row)[0], get(row)[1] + " (sic)")


def _pool_half(si):
    emb = si._batched.embedder
    orig = emb._batch

    def bad(texts, pad_to=0):
        toks, mask = orig(texts, pad_to)
        n = mask.sum(1, keepdim=True)
        keep = mask.cumsum(1) <= (n / 2).clamp(min=1)
        return toks, mask * keep
    emb._batch = bad


def _faults():
    """(cell, fault) for each fault a cell can have: every cell decodes
    misses; a cell whose mix sends stored rows also answers hits."""
    mixes = {w["name"]: json.loads((BENCH / "traffic" / f"{w['traffic']}"
                                    ".json").read_text())
             for w in BENCHMARK["workloads"]}
    for name, m in mixes.items():
        yield name, "token"
        yield name, "cache_not_written"
        if m["novel_per_block"] < m["block"]:
            yield name, "answer"
            yield name, "half_pooled"


@pytest.mark.parametrize("workload,fault", list(_faults()))
def test_faults_are_caught(bench, workload, fault, monkeypatch):
    from repro_torch.models import model as M

    def unchanged(si):
        # a decode step that leaves the cache as it found it
        monkeypatch.setattr(M, "_write", lambda c, pos, new, live:
                            None if live is None else c[:, pos].clone())
    plant = {"token": _alter_tokens, "answer": _alter_answers,
             "half_pooled": _pool_half, "cache_not_written": unchanged}
    result, _ = run_cell(bench, workload, fault=plant[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_comes_out_not_correct(bench, workload):
    """The bf16 control, held to the cell's limits by the same rule, fails
    where the program on the same run passes."""
    result, _ = run_cell(bench, workload, control=True)
    assert result["correct"], result["checks"]
    ctrl = result["control"]
    assert set(ctrl["checks"]) <= set(result["checks"])
    assert ctrl["checks"] and not ctrl["correct"], ctrl
    assert list(result)[-1] == "checks"
