"""The model-specific arithmetic a configuration file names: its FLOP
count, its reference forward pass and its keys on the port's config come
from ``reference/<stem>.py`` where the file says ``"reference":
"<stem>"``, and from ``reference/lm.py`` and ``flops`` where it says
nothing. Modules that stand for a new architecture are written to
``tmp_path``; nothing here writes under ``storbench/``."""
import json
import re

import pytest
import torch

import cell
import flops
import lm
import weights as W
from conftest import BENCHMARK, CELLS, ROOT, TINY, run_cell, tiny_config

CONFIGS = [c["name"] for c in BENCHMARK["configs"]]


def _file(name):
    entry = next(c for c in BENCHMARK["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


# flops.token_flops of each file at attended 16, 100 and 160, as counted
# before a configuration could name its own reference
PARENT_FLOPS = {
    "deepseek-v2-lite-16b-fp32": [4907040768.0, 4930265088.0, 4946853888.0],
    "starcoder2-7b-fp32": [14353956864.0, 14403502080.0, 14438891520.0],
}


@pytest.mark.parametrize("name", sorted(PARENT_FLOPS))
def test_token_flops_of_the_files_are_unchanged(name):
    c = _file(name)
    assert "reference" not in c
    assert [flops.token_flops(c, a) for a in (16, 100, 160)] == \
        PARENT_FLOPS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_naming_lm_is_the_default(name, tmp_path):
    """``"reference": "lm"`` runs ``lm.served_logits`` bit for bit, sets
    the same port config and counts the same FLOPs."""
    c = tiny_config(name)
    named = dict(c, reference="lm")
    pcfg = cell.port_config(c)
    assert cell.port_config(named) == pcfg
    params = W.fill(cell.lm_layout(pcfg, tmp_path), 2 ** 31 + 5,
                    torch.device("cpu"))
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(1, c["vocab_size"], (12,), generator=g).tolist()
    served = torch.randint(1, c["vocab_size"], (9,), generator=g).tolist()
    d_named, d_lm = [], []
    got = cell.reference(named).served_logits(
        named, params, prompt, served, cache_dtype=torch.bfloat16,
        drops=d_named)
    want = lm.served_logits(c, params, prompt, served,
                            cache_dtype=torch.bfloat16, drops=d_lm)
    assert torch.equal(got, want) and d_named == d_lm
    assert [flops.token_flops(named, a) for a in (16, 100, 160)] == \
        [flops.token_flops(c, a) for a in (16, 100, 160)]


COUNTED = '''
PORT_FIELDS = {"ssm_state_size": "ssm_state"}


def token_flops(c, attended):
    return 1000.0 * attended
'''


def test_a_named_module_counts_and_sets_its_fields(tmp_path, monkeypatch):
    c = dict(tiny_config("starcoder2-7b-fp32"), ssm_state_size=16)
    assert cell.port_config(c).ssm_state == 0
    (tmp_path / "counted.py").write_text(COUNTED)
    monkeypatch.setattr(cell, "REFERENCE", tmp_path)
    named = dict(c, reference="counted")
    assert flops.token_flops(named, 7) == 7000.0
    assert cell.port_config(named).ssm_state == 16


SHIFTED = '''"""The configuration's own reference with one served token's logit
lowered by 100: a reference the program's tokens disagree with."""
import {stem} as named

PORT_FIELDS = getattr(named, "PORT_FIELDS", {{}})


def served_logits(c, params, prompt, served, **kw):
    lg = named.served_logits(c, params, prompt, served, **kw)
    lg[0, served[0]] -= 100.0
    return lg
'''


@pytest.mark.parametrize("workload", CELLS)
def test_the_checks_use_the_named_reference(bench, workload, tmp_path,
                                            monkeypatch):
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    c = tiny_config(w["config"])
    stem = c.get("reference", cell.DEFAULT_REFERENCE)
    (tmp_path / "shifted.py").write_text(SHIFTED.format(stem=stem))
    monkeypatch.setattr(cell, "REFERENCE", tmp_path)
    result, _ = run_cell(bench, workload,
                         config=dict(c, reference="shifted"))
    off = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert not result["correct"]
    assert off and off <= {"logit_gap", "logit_gap_mean"}, result["checks"]


def test_a_missing_reference_stops_the_run_with_its_path(bench,
                                                         monkeypatch):
    def set_up(*a, **k):
        raise AssertionError("set-up started")
    monkeypatch.setattr(cell.world, "store_pairs", set_up)
    w = bench["workloads"][0]
    c = dict(tiny_config(w["config"]), reference="no_such_reference")
    path = cell.REFERENCE / "no_such_reference.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        run_cell(bench, w["name"], config=c)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_has_its_tiny_sizes(name):
    """A tiny file cuts sizes of keys its configuration has, and adds
    none: the program and the reference take the same code paths."""
    tiny = json.loads((TINY / f"{name}.json").read_text())
    assert tiny and set(tiny) <= set(_file(name))
