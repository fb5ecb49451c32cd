"""Dry run: count every (architecture x input shape) cell on the
production mesh, on the meta device, and write its H100 roofline terms
as JSON (the port of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory analysis, a jaxpr walk and the
partitioned HLO. The port runs eagerly, so a cell's step simply runs:
on a mesh of ``meta`` devices (``make_mesh(..., devices=["meta"] *
n)``), where every tensor has its shape and dtype and no memory and no
op computes anything, under ``launch/costs.Counter``. This is the one
entry point of the port whose device is not ``cuda``: like the
reference's placeholder devices, the meta mesh stands in for the 256 or
512 cards of the production mesh, which no machine here has, and needs
no card at all.

Per cell:
  1. ``specs.build_cell``'s plan; its inputs placed on the meta mesh;
  2. the step run once at full depth under the counter: FLOPs (products
     by dtype), bytes (the eager program's, and the least, ``bytes_min``),
     live bytes per mesh position with their peak, and the census of the
     collectives (``launch/collectives.py``);
  3. with ``--probes``, depth-1 and depth-2 plans are counted instead and
     every count extrapolated linearly to the full stack (the reference's
     method for collectives), except the hybrid and encdec stacks, which
     are counted at full depth as the reference counts them directly;
     eager counting needs no probes to be right, only to be quick;
  4. roofline terms on the H100 SXM (the constants below), per device
     at the busiest mesh position of each term:
       compute    = products at the rate of their dtype (f32 at the TF32
                    rate only where ``torch.backends.cuda.matmul.
                    allow_tf32`` is on, else on the CUDA cores) + the
                    other FLOPs at the f32 CUDA-core rate;
       memory     = ``bytes_min`` / HBM bandwidth (a lower bound; the
                    eager ``bytes`` stand beside it);
       collective = each group's bytes at the slowest link it crosses:
                    NVLink inside a node of ``NODE_CARDS`` cards (cards
                    numbered row-major over the mesh), one 400 Gb/s NDR
                    port per card between nodes. On pod16x16 the
                    ``model`` axis (16 cards) and the ``data`` axis both
                    cross nodes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--multipod/--single/--both-meshes] [--force] [--probes]

Results go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys where their meaning carries over
(``counts`` in place of ``jaxpr``, ``fits_80gb`` in place of
``fits_16gb``); ``launch/postprocess.py`` re-counts existing files.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import costs as C
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh

# NVIDIA H100 SXM5 (the H100 Tensor Core GPU data sheet), per card, dense
# (no sparsity), at its 700 W limit
BF16_FLOPS = 989e12           # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12           # TF32 tensor cores
F32_FLOPS = 67e12             # f32 on the CUDA cores
INT8_OPS = 1979e12            # int8 tensor cores
HBM_BYTES_S = 3.35e12         # HBM3 bandwidth
HBM_BYTES = 80e9              # HBM3 capacity
NVLINK_BYTES_S = 450e9        # NVLink 4, per direction, inside a node
NET_BYTES_S = 50e9            # one 400 Gb/s NDR port per card, between nodes
NODE_CARDS = 8                # cards per HGX node

PROBES = "depth-1/2 probes + linear extrapolation"
DIRECT = "census of the port's collectives, every layer run"

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b", "whisper-base",
         "llama3.2-3b", "starcoder2-7b", "qwen3-1.7b", "qwen2.5-32b",
         "zamba2-1.2b", "qwen2-vl-72b", "mamba2-130m"]

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def meta_mesh(name: str):
    """One of ``MESHES`` with every position on the meta device."""
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def product_rate(dtype: torch.dtype) -> float:
    """FLOP/s of a product whose inputs have ``dtype``."""
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_FLOPS
    if dtype in (torch.int8, torch.uint8):
        return INT8_OPS
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return TF32_FLOPS
    return F32_FLOPS


def link_rate(mesh, axes: str) -> float:
    """Bytes/s of a collective over ``axes`` (a census key, "a,b"): the
    slowest link its group crosses, NVLink when every member sits in one
    node of ``NODE_CARDS`` cards, else the network."""
    names = axes.split(",")
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    sub = [range(mesh.shape[a]) if a in names else range(1)
           for a in mesh.axis_names]
    cards = [int(np.ravel_multi_index(p, shape))
             for p in np.ndindex(*[len(r) for r in sub])]
    nodes = {c // NODE_CARDS for c in cards}
    return NVLINK_BYTES_S if len(nodes) == 1 else NET_BYTES_S


def place_args(plan):
    """The plan's inputs laid out by its ``in_shardings``."""
    return tuple(a if sh is None else Sh.place(a, sh)
                 for a, sh in zip(plan.arg_structs, plan.in_shardings))


def count_plan(plan, args=None):
    """Run ``plan.fn`` once on its placed inputs under a cost counter.
    Returns (counter, seconds)."""
    args = place_args(plan) if args is None else args
    t0 = time.perf_counter()
    with C.Counter() as c:
        c.add_args(args)
        out = plan.fn(*args)
        c.add_outputs(out)
    return c, time.perf_counter() - t0


def tally(c, mesh) -> dict:
    """A counter's numbers per device: memory at the busiest position, the
    global counts, the census at the busiest position, and each roofline
    term at its busiest position."""
    ps = range(math.prod(mesh.devices.shape))

    def compute_s(p):
        s = c.pos[p]
        t = sum(f / product_rate(dt) for dt, f in s.dot_by_dtype.items())
        return t + (s.flops - s.dot_flops) / F32_FLOPS

    top = max(ps, key=lambda p: c.peak[p])
    m = c.memory_at(top)
    g = c.costs()
    rate = functools.partial(link_rate, mesh)
    busy = c.census.busiest(rate)
    coll = c.census.at(busy)
    pc = max(ps, key=compute_s)
    pm = max(ps, key=c.bytes_min_at)
    return {
        "memory": {"args_gb": m["args"] / 1e9,
                   "temp_gb": (m["peak"] - m["args"] - m["out"]
                               + m["alias"]) / 1e9,
                   "out_gb": m["out"] / 1e9, "alias_gb": m["alias"] / 1e9,
                   "total_gb": m["peak"] / 1e9, "position": top},
        "counts": {"flops_global": g["flops"],
                   "dot_flops_global": g["dot_flops"],
                   "bytes_global": g["bytes"],
                   "bytes_min_global": g["bytes_min"],
                   "dot_flops_by_dtype": g["dot_flops_by_dtype"],
                   "kernels": g["kernels"], "warnings": g["warnings"]},
        "collectives": {"bytes_per_dev": coll["total_bytes"],
                        "by_op": coll["bytes"], "counts": coll["counts"],
                        "by_axis": coll["by_axis"], "position": busy},
        "terms": {"compute_s": compute_s(pc),
                  "memory_s": c.bytes_min_at(pm) / HBM_BYTES_S,
                  "collective_s": c.census.seconds_at(busy, rate)},
        "per_chip": {"flops": c.pos[pc].flops,
                     "bytes": c.bytes_min_at(pm),
                     "bytes_eager": max(c.pos[p].bytes for p in ps)},
    }


def _lerp(a, b, k):
    """a + (b - a) k over the numeric leaves of two tallies (b's other
    leaves kept)."""
    if isinstance(b, dict):
        return {key: _lerp(a.get(key, 0), v, k) if key != "position" else v
                for key, v in b.items()}
    if isinstance(b, (int, float)) and not isinstance(b, bool):
        return a + (b - a) * k
    return b


def roofline(t, cfg, shape, kind) -> dict:
    """The reference's roofline keys from a tally's terms."""
    terms = t["terms"]
    bound = max(terms.values())
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    model_flops = (6 if kind == "train" else 2) * cfg.active_param_count() \
        * tokens
    return dict(
        terms, dominant=max(terms, key=terms.get),
        flops_per_chip=t["per_chip"]["flops"],
        bytes_per_chip=t["per_chip"]["bytes"],
        bytes_eager_per_chip=t["per_chip"]["bytes_eager"],
        collective_bytes_per_chip=t["collectives"]["bytes_per_dev"],
        model_flops_global=model_flops,
        useful_flops_frac=model_flops / max(t["counts"]["flops_global"], 1),
        bound_step_time_s=bound,
        roofline_frac=terms["compute_s"] / max(bound, 1e-30))


def tally_cell(arch, shape_name, mesh, cfg, probes=False,
               run_overrides=None, accum=None):
    """(plan, tally, method, counting seconds) of one cell: every layer
    counted, or with ``probes`` the depth-1 and depth-2 plans counted and
    extrapolated to the full stack (not for hybrid and encdec stacks)."""
    plan = SP.build_cell(arch, shape_name, mesh, cfg=cfg,
                         run_overrides=run_overrides, accum=accum)
    if probes and not (cfg.family == "hybrid" or cfg.is_encoder_decoder):
        d1, d2, full_stack, s1 = SP.probe_depths(cfg)
        ts, secs = [], 0.0
        for dcfg in (d1, d2):
            c, s = count_plan(SP.build_cell(
                arch, shape_name, mesh, cfg=dcfg,
                run_overrides=run_overrides, accum=plan.notes.get("accum")))
            ts.append(tally(c, mesh))
            secs += s
        return plan, _lerp(ts[0], ts[1], full_stack - s1), PROBES, secs
    c, secs = count_plan(plan)
    return plan, tally(c, mesh), DIRECT, secs


def run_cell(arch, shape_name, *, multi_pod=False, mesh=None, cfg=None,
             probes=False, run_overrides=None, accum=None, verbose=True):
    """Count one cell and return its JSON record. ``mesh`` (default: the
    production meta mesh, ``multi_pod`` picks which) and ``cfg`` (default:
    the registered config) let a test count a small cell."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod) if mesh is None else "pod" + "x".join(
        str(s) for s in mesh.devices.shape)
    out = {"arch": arch, "shape": shape_name, "mesh": name, "status": "ok"}
    reason = SP.skip_reason(cfg, shape)
    if reason:
        out["status"] = reason
        return out
    mesh = meta_mesh(name) if mesh is None else mesh
    t0 = time.perf_counter()
    plan, t, method, secs = tally_cell(arch, shape_name, mesh, cfg, probes,
                                       run_overrides, accum)
    out["notes"] = plan.notes
    out["timings"] = {"plan_s": round(time.perf_counter() - t0 - secs, 2),
                      "count_s": round(secs, 2)}
    out["memory"] = dict(t["memory"], fits_80gb=t["memory"]["total_gb"]
                         < HBM_BYTES / 1e9)
    out["counts"] = t["counts"]
    out["collectives"] = dict(t["collectives"], method=method)
    out["roofline"] = roofline(t, cfg, shape, plan.kind)
    if verbose:
        print(json.dumps({k: out[k] for k in
                          ("arch", "shape", "mesh", "memory", "roofline")},
                         indent=1, default=str))
    return out


def cell_path(arch, shape_name, mesh_name_):
    return RESULTS_DIR / f"{arch}__{shape_name}__{mesh_name_}.json"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="single-pod 16x16 (default when not --multipod)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="count depths 1 and 2 and extrapolate")
    ap.add_argument("--no-probes", action="store_true",
                    help="count every layer (the default)")
    ap.add_argument("--accum", type=int, default=None)
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    meshes = [args.multipod] if not args.both_meshes else [False, True]
    cells = [(a, s) for a in ARCHS for s in SHAPES] if args.all \
        else [(args.arch, args.shape)]
    failures = 0
    for arch, shape_name in cells:
        for mp in meshes:
            path = cell_path(arch, shape_name, mesh_name(mp))
            if path.exists() and not args.force:
                print(f"[skip-cached] {path.name}")
                continue
            t0 = time.time()
            try:
                res = run_cell(arch, shape_name, multi_pod=mp,
                               probes=args.probes and not args.no_probes,
                               accum=args.accum, verbose=False)
            except Exception as e:      # one cell's failure is recorded
                failures += 1
                res = {"arch": arch, "shape": shape_name,
                       "mesh": mesh_name(mp),
                       "status": f"FAIL: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            res["wall_s"] = round(time.time() - t0, 1)
            path.write_text(json.dumps(res, indent=1, default=str))
            print(f"[{res['status'][:60]:<60}] {path.name} "
                  f"({res['wall_s']}s)")
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
