"""The benchmark's own CPU tests (run them with ``PYTHONPATH=src python -m
pytest -q storbench/tests`` from the checkout's root): the traffic, the
readers, the roofline arithmetic, the import rule, and every cell run end
to end at a tiny size on the CPU, sound and with faults planted."""
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = Path(__file__).resolve().parent / "tiny"
# the benchmark's configurations and cells, for module-level lists of tests
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
for p in (ROOT / "src", BENCH, BENCH / "traffic", BENCH / "reference"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny_config(name: str) -> dict:
    """The configuration file ``name`` with its sizes cut to a CPU's by
    ``tests/tiny/<name>.json`` (the keys it sets replace the file's): the
    same keys, so the same code paths in the program and the reference."""
    entry = next(x for x in BENCHMARK["configs"] if x["name"] == name)
    c = json.loads((ROOT / entry["file"]).read_text())
    c.update(json.loads((TINY / f"{name}.json").read_text()))
    c["system"] = dict(c["system"], store_rows=2000,
                       minilm=dict(dim=64, layers=2, heads=2, d_ff=128,
                                   embed_std=1.0))
    return c


def tiny_mix(name: str) -> dict:
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    m.update(clients=4, decode_slots=4, max_new_lo=8, max_new_hi=24,
             blocks_per_client=12)
    return m


def run_cell(bench, workload, trace=False, fault=None, seed=2 ** 31 + 77,
             control=False, config=None):
    """One run of ``workload`` on the CPU at its tiny size (``config`` in
    place of its tiny configuration)."""
    import cell
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return cell.run(cell.Opts(
        root=ROOT, workload=workload, seed=seed, seconds=3.0, trace=trace,
        t_start=time.perf_counter(), device="cpu",
        config=config or tiny_config(w["config"]),
        traffic=tiny_mix(w["traffic"]), limits=limits, fault=fault,
        control=control))


@pytest.fixture(scope="session")
def bench():
    return BENCHMARK
