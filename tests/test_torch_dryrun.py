"""The port's dry-run tooling (``repro_torch.launch.{costs,collectives,
specs,dryrun,postprocess}``) on the CPU and the meta device, held to the
reference's ``repro.launch`` where the two compute the same thing: the
known-program count, the params' element counts, the cell plans' notes
and argument shapes; and to closed forms where the port has its own
collectives (the census of a mesh train step). The parity of the plans'
product FLOPs, and the probes, are in ``test_torch_dryrun_parity.py``."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_configs as ref_list_configs
from repro.configs import reduced as ref_reduced
from repro.launch import specs as RS
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distributed import sharding as Sh
from repro_torch.kernels import ops
from repro_torch.launch import collectives as CL
from repro_torch.launch import costs as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch import postprocess as PP
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractMesh, make_mesh
from repro_torch.models.convert import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def meta_mesh(data, model):
    return make_mesh((data, model), ("data", "model"),
                     devices=["meta"] * (data * model))


# ---------------------------------------------------------------------------
# (i) the counter on known programs
# ---------------------------------------------------------------------------


def test_known_program_counts_exactly():
    """A loop of 4 products of 64x64 f32 (the reference's
    ``test_jaxpr_costs_exact_on_known_program``): 4 * 2 * 64^3 FLOPs, each
    product reading two operands and writing one, the least bytes the two
    inputs and the output."""
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn(64, 64, generator=g) for _ in range(2))

    def loop(x, w):
        for _ in range(4):
            x = x @ w
        return x

    c = C.fn_costs(loop, a, b)
    assert c["dot_flops"] == c["flops"] == 4 * 2 * 64 ** 3
    assert c["dot_flops_by_dtype"] == {"float32": 4 * 2 * 64 ** 3}
    assert c["bytes"] == 4 * 3 * 64 * 64 * 4
    assert c["bytes_min"] == 3 * 64 * 64 * 4
    assert c["by_op"] == {"mm": {"calls": 4, "flops": 4 * 2 * 64 ** 3,
                                 "bytes": 4 * 3 * 64 * 64 * 4}}
    meta = C.fn_costs(loop, a.to("meta"), b.to("meta"))
    assert {k: meta[k] for k in ("flops", "bytes", "bytes_min")} == \
        {k: c[k] for k in ("flops", "bytes", "bytes_min")}


def test_conventions_views_and_backward():
    """Elementwise 1 per output element, reductions 1 per input element,
    sort and top-k 10 per element, comparisons and views free; the
    backward is counted as it runs."""
    x = torch.randn(8, 16)
    c = C.fn_costs(lambda t: ((t * 2).exp() > 1).float().sum(), x)
    assert c["flops"] == 128 + 128 + 128          # mul, exp, sum; gt free
    c = C.fn_costs(lambda t: torch.topk(t.t().reshape(16, 8), 3), x)
    assert c["flops"] == 10 * 128 and c["by_op"].keys() == {"topk"}
    w = torch.randn(16, 4, requires_grad=True)

    def fwd_bwd(t, w):
        (t @ w).sum().backward()
        return w.grad

    c = C.fn_costs(fwd_bwd, x, w)
    # forward product, then the grad of w: x^T @ grad (8 x 16 x 4)
    assert c["dot_flops"] == 2 * (2 * 8 * 16 * 4)


# ---------------------------------------------------------------------------
# (vii) the kernel wrappers' credit
# ---------------------------------------------------------------------------


def _kernel_calls(dev):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)          # noqa: E731
    q8 = torch.randint(-127, 128, (3, 40), generator=g).to(torch.int8)
    x8 = torch.randint(-127, 128, (300, 40), generator=g).to(torch.int8)
    full = torch.full((2,), 49, dtype=torch.int32)
    cases = {
        "mips_topk": (lambda q, x: ops.mips_topk(q, x, 5, 128),
                      (r(3, 40), r(300, 40).half())),
        "mips_topk_int8": (lambda *a: ops.mips_topk_int8(*a, 5, 128),
                           (q8, r(3).abs(), x8, r(300).abs())),
        "decode_attention": (ops.decode_attention,
                             (r(2, 8, 32), r(2, 50, 4, 32), r(2, 50, 4, 32),
                              full)),
        "flash_attention": (lambda *a: ops.flash_attention(*a, True),
                            (r(2, 30, 4, 32), r(2, 40, 2, 32),
                             r(2, 40, 2, 16))),
    }
    return {k: (fn, tuple(a.to(dev) for a in args))
            for k, (fn, args) in cases.items()}


@pytest.mark.parametrize("name", ["mips_topk", "mips_topk_int8",
                                  "decode_attention", "flash_attention"])
def test_kernel_credit_same_on_cpu_and_meta(name):
    """One wrapper call counts the same on the CPU (the plain version
    runs) and on meta (shapes only): the kernel's own work, its inner ops
    not counted again, no launch counted."""
    ops.reset_launch_counts()
    got = {}
    for dev in ("cpu", "meta"):
        fn, args = _kernel_calls(dev)[name]
        got[dev] = C.fn_costs(fn, *args)
    assert got["cpu"] == got["meta"]
    k = got["cpu"]["kernels"][name]
    assert k["calls"] == 1 and k["flops"] == got["cpu"]["dot_flops"]
    assert ops.launch_counts()[name] == 0
    fn, args = _kernel_calls("cpu")[name]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    assert got["cpu"]["bytes_min"] == sum(C.nbytes(t) for t in args) + \
        sum(C.nbytes(t) for t in outs) + k["bytes"]


def test_kernel_work_formulas():
    """B1/B2 2QND, B3 4 Hq D per attended row (the lengths' rows where
    known, every row on meta), B4 2 (D + Dv) per scored pair and head
    (the causal triangle)."""
    calls = _kernel_calls("cpu")
    q, x = calls["mips_topk"][1]
    assert ops.mips_work(q, x, 5, 128) == (
        2 * 3 * 300 * 40, C.nbytes(q) + C.nbytes(x) + 3 * 3 * 5 * 8)
    q, k, v, _ = calls["decode_attention"][1]
    short = torch.tensor([9, 60], dtype=torch.int32)   # 10 + 50 rows
    flops, moved = ops.decode_work(q, k, v, short)
    assert flops == 4 * 60 * 8 * 32
    assert moved == C.nbytes(q) + 8 + 60 * 4 * 32 * 4 * 2 + 2 * 8 * 32 * 4
    assert ops.decode_work(q, k, v, short.to("meta"))[0] == \
        4 * 100 * 8 * 32
    assert ops.flash_pairs(30, 40, True) == 30 * 31 // 2
    assert ops.flash_pairs(40, 30, True) == 30 * 31 // 2 + 10 * 30
    q, k, v = calls["flash_attention"][1]
    assert ops.flash_work(q, k, v, False)[0] == 2 * 2 * 4 * 30 * 40 * 48


def test_kernel_wrappers_refuse_a_mix_of_devices():
    """Meta computes shapes only; a mix of meta and the CPU raises, as a
    mix of the card and the CPU does."""
    q = torch.randn(3, 40)
    out = ops.mips_topk(q.to("meta"), torch.randn(300, 40, device="meta"),
                        5)
    assert out[0].device.type == "meta" and out[0].shape == (3, 5)
    with pytest.raises(ValueError, match="on meta"):
        ops.mips_topk(q, torch.randn(300, 40, device="meta"), 5)


# ---------------------------------------------------------------------------
# (iii) params at full size on meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ref_list_configs()))
def test_params_struct_matches_reference(arch):
    from repro.models import model as RM
    cfg = get_config(arch)
    ps = SP.params_struct(cfg)
    leaves = list(tree_leaves(ps))
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    ref = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0),
                                               ref_get_config(arch)))
    ref_n = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(ref))
    assert n == ref_n
    # the configs' closed formula; where it misses leaves of the init
    # (deepseek-v2-lite-16b), it misses the same in both packages
    assert n - cfg.param_count() == \
        ref_n - ref_get_config(arch).param_count()
    assert {str(t.dtype).replace("torch.", "") for t in leaves} == \
        {str(x.dtype) for x in jax.tree_util.tree_leaves(ref)}


# ---------------------------------------------------------------------------
# (iv) the plans' notes and argument shapes
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-130m",
                "zamba2-1.2b", "whisper-base", "qwen2-vl-72b"]


def _leaf_shapes(tree):
    return sorted(tuple(x.shape) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_build_cell_notes_and_shapes_match_reference(arch, monkeypatch):
    """Train, prefill and decode at 64 tokens x 2 rows on a 1x1 mesh, the
    reduced config: the same notes, batch, token and cache shapes and
    parameter count; the kinds and donations the reference's."""
    from repro.configs import base as RB
    rmesh = ref_local_mesh()
    mesh = meta_mesh(1, 1)
    cfg = reduced(get_config(arch))
    for kind in ("train", "prefill", "decode"):
        name = f"tiny_{kind}"
        monkeypatch.setitem(RB.SHAPES, name, RB.ShapeConfig(name, 64, 2,
                                                             kind))
        ref = RS.build_cell(arch, name, rmesh,
                            cfg=ref_reduced(ref_get_config(arch)))
        plan = SP.build_cell(arch, ShapeConfig(name, 64, 2, kind), mesh,
                             cfg=cfg)
        assert plan.notes == ref.notes and plan.kind == ref.kind
        assert plan.donate == ref.donate
        assert len(plan.arg_structs) == len(ref.arg_structs)
        ps, rps = plan.arg_structs[0], ref.arg_structs[0]
        assert sum(t.numel() for t in tree_leaves(ps)) == sum(
            math.prod(x.shape) for x in jax.tree_util.tree_leaves(rps))
        for mine, theirs in zip(plan.arg_structs[1:], ref.arg_structs[1:]):
            if kind == "train" and isinstance(mine, dict) and \
                    "master" in mine:
                continue                  # AdamW state: as the params
            if isinstance(mine, int):     # decode's cache_len: S - 1
                assert mine == 63 and theirs.shape == ()
                continue
            assert _leaf_shapes(mine) == _leaf_shapes(theirs)


def test_build_cell_notes_on_a_larger_abstract_mesh():
    """On (data 2, model 4), which this CPU has no eight devices for, both
    packages plan on abstract meshes: the same notes for every family's
    full config and shape."""
    from jax.sharding import AbstractMesh as RAbstract
    from jax.sharding import AxisType
    rmesh = RAbstract((2, 4), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    for arch in FAMILY_ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            ref = RS.build_cell(arch, shape, rmesh)
            plan = SP.build_cell(arch, shape, mesh)
            assert plan.notes == ref.notes, (arch, shape)


def test_dp_only_strips_the_model_axis():
    plan = SP.build_cell("qwen3-1.7b", ShapeConfig("t", 64, 8, "train"),
                         AbstractMesh((2, 4), ("data", "model")),
                         cfg=reduced(get_config("qwen3-1.7b")),
                         run_overrides={"_dp_only": True})
    specs = [s.spec for s in tree_leaves(plan.in_shardings[0])
             if isinstance(s, Sh.NamedSharding)]
    assert specs and all("model" not in Sh._axes(e)
                         for sp in specs for e in sp)
    assert plan.run.batch_axes == ("data", "model")
    assert not plan.run.heads_sharded


# ---------------------------------------------------------------------------
# (v) the census of a mesh train step against a closed form
# ---------------------------------------------------------------------------


def test_census_of_a_dense_train_step_per_layer():
    """Reduced qwen3 trained on a (data 2, model 2) meta mesh, 4 x 64
    tokens, accum 2 (remat on): what one more layer adds at position 0
    (depth 2 minus depth 1), against the closed form of
    ``distributed/train_parallel.py``'s step. Each microbatch, per layer:

    * FSDP: each of the 7 matrices (wq, wk, wv, wo, w1, w3, w2, split
      over data, wq..w3 also over model) is all-gathered over data in the
      forward and again in remat's recompute; the backward reduce-scatters
      its gradient once (the same bytes);
    * TP: the attention's and the MLP's outputs are psum'd over model in
      the forward; the recompute stops at the last tensor the backward
      saves, so it psums the attention's output only; the backward psums
      both gradients: 5 all-reduces of one row's activations, 2x bytes;
    * the replicated leaves' gradients (ln1, ln2, q_norm, k_norm, f32) are
      summed over data and model (``psum_replicas``), 2x bytes."""
    base = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                               dtype="bfloat16")
    mesh = meta_mesh(2, 2)
    shape = ShapeConfig("t", 64, 4, "train")
    recs = []
    for depth in (1, 2):
        plan = SP.build_cell("qwen3-1.7b", shape, mesh,
                             cfg=dataclasses.replace(base, n_layers=depth))
        assert plan.notes["accum"] == 2 and plan.run.remat
        c, _ = DR.count_plan(plan)
        recs.append(c.census)
    d, hd, ff = base.d_model, base.resolved_head_dim, base.d_ff
    hq, hkv = base.n_heads, base.n_kv_heads
    bf16 = 2
    gathered = bf16 * (d * hq * hd // 2 + 2 * d * hkv * hd // 2 +
                       hq * hd // 2 * d + 2 * d * ff // 2 + ff // 2 * d)
    act = 1 * 64 * d * bf16               # one row per data shard
    rep = 4 * (2 * d + 2 * hd)            # f32 grads of the norms
    accum = 2
    want = {("all-gather", "data"): (accum * 2 * 7, accum * 2 * gathered),
            ("reduce-scatter", "data"): (accum * 7, accum * gathered),
            ("all-reduce", "model"): (accum * 5, accum * 5 * 2 * act),
            ("all-reduce", "data,model"): (accum * 4, accum * 2 * rep)}

    def at0(census):
        out = {}
        for (p, op, axes, _), (n, b) in census.records.items():
            if p == 0:
                out[(op, axes)] = (n, b)
        return out

    one, two = at0(recs[0]), at0(recs[1])
    per_layer = {k: (two[k][0] - one.get(k, (0, 0))[0],
                     two[k][1] - one.get(k, (0, 0))[1]) for k in two}
    assert per_layer == want


def test_collectives_report_without_changing_values():
    """Under a counter, the one-controller collectives on CPU shards give
    the values they give without one, and each group's traffic is
    recorded per member by the reference's model; a group of one member
    records nothing."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x = Sh.shard(torch.arange(16.0).reshape(4, 4), ("data", "model"), mesh)
    plain = [Sh.all_gather(x, "model", 1), Sh.psum(x, "data"),
             Sh.all_to_all(x, "model", 0, 0)]
    with C.Counter() as c:
        counted = [Sh.all_gather(x, "model", 1), Sh.psum(x, "data"),
                   Sh.all_to_all(x, "model", 0, 0),
                   Sh.psum(x, ())]
    for a, b in zip(plain, counted):
        for s, t in zip(Sh.parts(a), Sh.parts(b)):
            assert torch.equal(s, t)
    # each shard 2 x 2 f32 (16 bytes): the gather's result is 32 bytes,
    # the psum's 16 (2x on the wire), the all-to-all's 16
    assert c.census.at(3) == {
        "counts": {"all-gather": 1, "all-reduce": 1, "all-to-all": 1},
        "bytes": {"all-gather": 32, "all-reduce": 32, "all-to-all": 16},
        "total_bytes": 80.0, "by_axis": {"model": 48, "data": 32}}
    assert c.costs()["flops"] == 0        # the collectives' own ops
    assert CL.traffic("reduce-scatter", 10, 4) == 40


def test_link_rates_of_the_production_meshes():
    """16 model cards span two 8-card nodes, so both axes of pod16x16
    cross nodes; (data 2, model 2) sits in one node (NVLink)."""
    big = AbstractMesh((16, 16), ("data", "model"))
    small = meta_mesh(2, 2)
    assert DR.link_rate(big, "model") == DR.NET_BYTES_S
    assert DR.link_rate(big, "data") == DR.NET_BYTES_S
    assert DR.link_rate(small, "data,model") == DR.NVLINK_BYTES_S


# ---------------------------------------------------------------------------
# (viii) the command line
# ---------------------------------------------------------------------------

KEYS = {
    "memory": {"args_gb", "temp_gb", "out_gb", "alias_gb", "total_gb",
               "fits_80gb"},
    "counts": {"flops_global", "dot_flops_global", "bytes_global",
               "bytes_min_global"},
    "collectives": {"method", "bytes_per_dev", "by_op", "by_axis"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant",
                 "flops_per_chip", "bytes_per_chip",
                 "collective_bytes_per_chip", "model_flops_global",
                 "useful_flops_frac", "bound_step_time_s",
                 "roofline_frac"},
}


def test_command_line_writes_the_cell_json(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
    decode_32k`` in a subprocess. The full cell (1.7 B params, 256 meta
    shards, every layer) takes about a minute on this CPU, so the
    subprocess counts the reduced config on a (data 2, model 2) mesh
    under the production mesh's name; then ``postprocess`` re-counts the
    file and keeps its memory and collectives."""
    code = f"""
import sys
from repro_torch.configs import base, get_config, reduced
from repro_torch.launch import dryrun as DR
full = base.get_config
DR.get_config = lambda a: reduced(full(a))
DR.MESHES["pod16x16"] = ((2, 2), ("data", "model"))
DR.RESULTS_DIR = __import__("pathlib").Path({str(tmp_path)!r})
DR.main(sys.argv[1:])
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "qwen3-1.7b", "--shape",
         "decode_32k"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    path = tmp_path / "qwen3-1.7b__decode_32k__pod16x16.json"
    d = json.loads(path.read_text())
    assert d["status"] == "ok" and d["mesh"] == "pod16x16"
    assert {"arch", "shape", "notes", "timings"} <= d.keys()
    for section, keys in KEYS.items():
        assert keys <= d[section].keys(), section
    assert d["notes"]["decode_attn"] == "seq_sharded"
    assert d["collectives"]["by_axis"] == {"model": d["collectives"][
        "bytes_per_dev"]}
    r = d["roofline"]
    assert r["bound_step_time_s"] == max(r["compute_s"], r["memory_s"],
                                         r["collective_s"])
    assert r["memory_s"] == r["bytes_per_chip"] / DR.HBM_BYTES_S
    assert 0 < r["useful_flops_frac"] <= 1

    # postprocess: the same counts again, memory and collectives kept
    d["memory"]["total_gb"] = -1.0
    path.write_text(json.dumps(d))
    monkeypatch.setattr(PP, "get_config", lambda a: reduced(get_config(a)))
    monkeypatch.setitem(DR.MESHES, "pod16x16", ((2, 2), ("data", "model")))
    assert PP.refresh(path) == "ok"
    e = json.loads(path.read_text())
    assert e["memory"]["total_gb"] == -1.0
    assert e["counts"] == d["counts"]
    assert e["roofline"]["collective_s"] == r["collective_s"]
