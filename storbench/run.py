"""Run one cell of the benchmark once and print its result line.

    python3 storbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic mix and per-layer metrics are found by
the names ``BENCHMARK.json`` gives them (``storbench/configs``,
``storbench/traffic``, ``storbench/metrics``). The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and
``checks`` last: each number compared with its limit); the last lines of
standard error repeat the checks. The run needs as many CUDA cards as the
cell asks for, and runs the PyTorch port (``src/repro_torch``) of the
checkout it sits in.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or its libraries write lies at a fixed path in
# the checkout (the port's nvcc builds go to build/kernels there already)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict, notes) -> None:
    """What the checks compared, then each number beside its limit as the
    last lines of standard error; the result as the last line of standard
    output."""
    for n in notes:
        print(n, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}; have {sorted(cells)}",
              file=sys.stderr)
        return 2
    import torch
    need = cells[a.workload]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"{a.workload} needs {need} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "storbench"))
    import cell
    result, notes = cell.run(cell.Opts(
        root=ROOT, workload=a.workload, seed=a.seed, seconds=a.seconds,
        trace=bool(a.trace), t_start=T_START, device="cuda"))
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the PyTorch port "
              "alone", file=sys.stderr)
        return 4
    emit(result, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
