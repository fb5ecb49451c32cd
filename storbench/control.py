"""Read the control beside the program's own numbers, on the chip.

    python3 storbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 20

For each seed, one run of the cell as ``run.py`` makes it (set-up, the
closed loop at the cell's own load, the checks), and then the control:
the reference put in the program's place in bf16, one precision below the
configurations' f32, on the same queries, prompts and served tokens. The
control's numbers are held to the cell's limits in ``storbench/limits``
by the rule that decides the program's ``correct``. Each seed prints one
JSON line with the program's verdict and numbers (``correct``,
``checks``: the lower readings) and the control's (``control_correct``,
``control``: the upper readings). The command exits 5 if the control
came out correct on any seed: the limits then fail to tell the two
apart. The benchmark's runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets the caches and the import path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args(argv)
    seeds = [int(x) for x in a.seeds.split(",")]
    if len(seeds) > 1:
        # one process a seed: each holds the whole model on the card
        rcs = [subprocess.run([sys.executable, __file__, "--workload",
                               a.workload, "--seeds", str(seed),
                               "--seconds", str(a.seconds)]).returncode
               for seed in seeds]
        return max(rcs)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    import cell
    result, notes = cell.run(cell.Opts(
        root=run.ROOT, workload=a.workload, seed=seeds[0],
        seconds=a.seconds, trace=False, t_start=T_START, control=True))
    ctrl = result["control"]
    print(json.dumps({"workload": a.workload, "seed": seeds[0],
                      "correct": result["correct"],
                      "failed": result["failed"],
                      "control_correct": ctrl["correct"],
                      "checks": result["checks"],
                      "control": ctrl["checks"], "notes": notes}),
          flush=True)
    if ctrl["correct"]:
        print(f"the control came out correct on seed {seeds[0]}",
              file=sys.stderr)
        return 5
    return 0

if __name__ == "__main__":
    sys.exit(main())
