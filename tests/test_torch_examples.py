"""The examples' port counterparts (``examples/*_torch.py``) on the CPU.

``quickstart_torch.py`` and ``storinfer_serve_torch.py`` run beside the
reference scripts they port, at the reference's sizes (each takes
seconds): the quickstart's printed store, hit rate and example response
equal the reference's line for line (timings aside), and the serve
example's hit flags and cancellations equal the reference's in all three
sections (the LMs' random weights differ, so miss texts do not).
``train_small_torch.py`` trains a few steps at a small size, its loss
falls, and it resumes from its checkpoint.
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _untimed(text):
    """The printed lines with the wall-clock numbers taken out."""
    text = re.sub(r"\d+\.\d+s, \d+ pairs/s", "T", text)
    return re.sub(r"search \d+\.\d+ ms", "search T", text)


def test_quickstart_counterpart_equals_the_reference(capsys):
    _load("quickstart").main()
    want = capsys.readouterr().out
    got = _load("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert _untimed(out) == _untimed(want)
    assert got["generated"] == 1500 and got["source"] == "store"
    assert f"hit rate @0.9 over 400 user queries: {got['hit_rate']:.3f}" \
        in want


def _flags(text):
    """Per section: each line's ``hit=``/``cancelled=`` flags."""
    return [[f for f in (tuple(re.findall(r"(?:hit|cancelled)=(?:True|"
                                          r"False)", line))
                         for line in part.splitlines()) if f]
            for part in text.split("=== ")[1:]]


def test_serve_counterpart_flags_equal_the_reference(capsys):
    _load("storinfer_serve").main()
    want = capsys.readouterr().out
    got = _load("storinfer_serve_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [len(f) for f in _flags(want)] == [6, 4, 6]
    assert _flags(out) == _flags(want)
    assert [c for c, _ in got["scheduler"]] == [False, True, False, False]
    assert got["query"] == [h for h, _ in got["serve"]]
    assert any(got["query"]) and not all(got["query"])
    tail = re.search(r"stats: (\d+) queries, (\d+) hits", want).groups()
    assert re.search(r"stats: (\d+) queries, (\d+) hits", out).groups() \
        == tail


def test_train_small_counterpart_learns_and_resumes(tmp_path, capsys):
    ex = _load("train_small_torch")
    base = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt",
            str(tmp_path / "ck"), "--ckpt-every", "10"]
    first = ex.main(base + ["--steps", "30"])
    assert first["start"] == 0 and len(first["losses"]) == 30
    losses = first["losses"]
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.5
    second = ex.main(base + ["--steps", "40", "--resume", "--compress"])
    out = capsys.readouterr().out
    assert "resumed from step 30" in out and second["start"] == 30
    assert len(second["losses"]) == 10
    assert max(second["losses"]) < losses[0]
