"""The product FLOPs the port's counter (``repro_torch.launch.costs``)
finds in ``build_cell``'s train, prefill and decode plans, held to the
reference's ``dot_general`` FLOPs for the same plans: one reduced config
of each family, 64 tokens x 2 rows, a 1x1 mesh (the port's on meta).

With them, the depth-1/2 probes' extrapolation, held to the full-depth
count.

The reference's count walks the jaxpr and multiplies each scan body by
its trip count, as ``repro.launch.costs.jaxpr_costs`` does. Two kinds of
difference are named rather than hidden:

* ``dot_general``s with no contracting dimension (jnp.einsum's
  elementwise and outer products, e.g. the SSD's ``bchqs,bchqs`` and
  ``bh,bhn,bhp->bhpn``): torch computes these with ``mul``, an elementwise
  op, which the port's count puts in ``flops``, not ``dot_flops``. They
  are taken out of the reference's side.
* work the port really does otherwise (``GAPS``), each pinned."""
import dataclasses
from collections import Counter

import jax
import pytest

from repro.configs import base as RB
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch import costs as RC
from repro.launch import specs as RS
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh

ARCHS = ["qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-130m",
         "zamba2-1.2b", "whisper-base", "qwen2-vl-72b"]

# reference (contracting dot_generals) minus port, FLOPs
GAPS = {
    # the attention's backward: the reference differentiates its blockwise
    # scan, the port's flash backward (models/blockwise.py) recomputes the
    # probabilities from the saved log-sum-exp: 2 fewer S x T x D
    # products per layer and microbatch (checked below)
    ("qwen3-1.7b", "train"): 6291456,
    # MLA's blockwise backward, 7,864,320 fewer, less 4,194,304 that the
    # port's remat recomputes beyond the reference's (its checkpoint reruns
    # the whole layer)
    ("deepseek-v2-lite-16b", "train"): 3670016,
    # the SSD's three-operand einsums (y_off, the chunk states) contract
    # in another order: torch.einsum left to right, jnp.einsum by
    # opt_einsum's path; two products of 98,304 in the backward
    ("mamba2-130m", "train"): 196608,
    # the shared attention block's backward and the SSD's einsum order
    ("zamba2-1.2b", "train"): 14483456,
    # remat: the port recomputes whisper's encoder and decoder layers in
    # the backward (37,748,736), the reference's unrolled encdec stack does
    # not remat; less the attention backward's 10,485,760
    ("whisper-base", "train"): -27262976,
    # M-RoPE's section select is a one-hot product in the reference
    # (einsum "tbsd,dt->bsd"), an index in the port; train also has the
    # attention backward's 6,291,456
    ("qwen2-vl-72b", "train"): 6340608,
    ("qwen2-vl-72b", "prefill"): 36864,
    ("qwen2-vl-72b", "decode"): 576,
}


def ref_dot_flops(jaxpr, mult=1, acc=None):
    """{"all", "no_contraction"}: dot_general FLOPs of a jaxpr, scan
    bodies times their length, shard_map bodies times the mesh size, the
    costliest branch of a cond."""
    acc = Counter() if acc is None else acc
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            f = mult * RC._dot_flops(eqn)
            acc["all"] += f
            if not eqn.params["dimension_numbers"][0][0]:
                acc["no_contraction"] += f
        subs = RC._sub_jaxprs(eqn.params)
        m = mult
        if name == "scan":
            m = mult * eqn.params.get("length", 1)
        elif name == "shard_map":
            m = mult * (getattr(eqn.params.get("mesh"), "size", 1) or 1)
        if name == "cond":
            acc.update(max((ref_dot_flops(s, m) for s in subs),
                           key=lambda c: c["all"], default=Counter()))
        else:
            for s in subs:
                ref_dot_flops(s, m, acc)
    return acc


@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_reference(arch, monkeypatch):
    rmesh = ref_local_mesh()
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    cfg = reduced(get_config(arch))
    for kind in ("train", "prefill", "decode"):
        name = f"tiny_{kind}"
        monkeypatch.setitem(RB.SHAPES, name,
                            RB.ShapeConfig(name, 64, 2, kind))
        ref = RS.build_cell(arch, name, rmesh,
                            cfg=ref_reduced(ref_get_config(arch)))
        rd = ref_dot_flops(jax.make_jaxpr(ref.fn)(*ref.arg_structs).jaxpr)
        plan = SP.build_cell(arch, ShapeConfig(name, 64, 2, kind), mesh,
                             cfg=cfg)
        c, _ = DR.count_plan(plan)
        port = c.costs()["dot_flops"]
        assert rd["all"] - rd["no_contraction"] - port == \
            GAPS.get((arch, kind), 0), (arch, kind)
        if (arch, kind) == ("qwen3-1.7b", "train"):
            # 2 products of 2 b Hq S T D a layer and microbatch
            b = 2 // plan.notes["accum"]
            product = 2 * b * cfg.n_heads * 64 * 64 * cfg.resolved_head_dim
            assert GAPS[(arch, kind)] == \
                2 * cfg.n_layers * plan.notes["accum"] * product


# ---------------------------------------------------------------------------
# (vi) probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_probe_extrapolation_equals_full_depth(arch, monkeypatch):
    """At the reduced size on (data 2, model 2): depth-1 and depth-2 counts
    extrapolated to the full stack equal the full-depth count."""
    monkeypatch.setitem(SHAPES, "tiny_train",
                        ShapeConfig("tiny_train", 64, 4, "train"))
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              n_layers=reduced(get_config(arch)).n_layers
                              + 1)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    full = DR.run_cell(arch, "tiny_train", mesh=mesh, cfg=cfg,
                       verbose=False)
    probed = DR.run_cell(arch, "tiny_train", mesh=mesh, cfg=cfg,
                         probes=True, verbose=False)
    assert probed["collectives"]["method"] == DR.PROBES
    for key in ("flops_global", "dot_flops_global", "bytes_global",
                "bytes_min_global"):
        assert probed["counts"][key] == full["counts"][key], key
    assert probed["collectives"]["bytes_per_dev"] == \
        full["collectives"]["bytes_per_dev"]
    for key in ("compute_s", "memory_s", "collective_s"):
        assert probed["roofline"][key] == pytest.approx(
            full["roofline"][key], rel=1e-12)
