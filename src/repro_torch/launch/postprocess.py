"""Re-count ``counts`` and ``roofline`` in existing dry-run JSONs (the
port of the JAX package's ``launch/postprocess.py``): each cell is counted
again by the method its file records, and ``memory`` and ``collectives``
are kept from the file, as the reference keeps its compile's.

  PYTHONPATH=src python -m repro_torch.launch.postprocess
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as DR


def refresh(path: Path) -> str:
    d = json.loads(path.read_text())
    if d.get("status") != "ok":
        return "skip"
    cfg = get_config(d["arch"])
    mesh = DR.meta_mesh(d["mesh"])
    probes = d.get("collectives", {}).get("method") == DR.PROBES
    plan, t, _, _ = DR.tally_cell(d["arch"], d["shape"], mesh, cfg, probes,
                                  accum=d.get("notes", {}).get("accum"))
    d["counts"] = t["counts"]
    # the kept collectives stand in the terms
    t["collectives"] = d["collectives"]
    t["terms"]["collective_s"] = d["roofline"]["collective_s"]
    d["roofline"] = DR.roofline(t, cfg, SHAPES[d["shape"]], plan.kind)
    path.write_text(json.dumps(d, indent=1, default=str))
    return "ok"


def main(results_dir: Path = DR.RESULTS_DIR):
    for p in sorted(results_dir.glob("*.json")):
        try:
            r = refresh(p)
        except Exception as e:          # one file's failure is reported
            r = f"ERR {type(e).__name__}: {e}"
        print(p.name, r, flush=True)


if __name__ == "__main__":
    main()
