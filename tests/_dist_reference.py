"""The JAX package's mesh paths on eight forced host devices, forward only:
writes their inputs (numpy, from a seed) and outputs to one ``.npz`` for
``tests/test_torch_distributed.py`` to hold the port to.

    python tests/_dist_reference.py OUT.npz

On a (data 2, model 4) mesh: ``sharded_mips_topk`` (float; int8 with
``n_real`` at an odd N), the float ``ShardedIndex`` at an odd N (its
-1e4 padding rows), ``gqa_decode_seq_sharded`` with the write landing in
shard 2, ``mla_decode_seq_sharded`` (shard 1), and ``moe_ffn_ep`` at the
reduced deepseek config with the full config's capacity factor (1.25),
where assignments drop per shard.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core.index import ShardedIndex  # noqa: E402
from repro.distributed.decode_attn import (  # noqa: E402
    gqa_decode_seq_sharded, mla_decode_seq_sharded)
from repro.distributed.moe_parallel import moe_ffn_ep  # noqa: E402
from repro.distributed.topk import sharded_mips_topk  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import moe as Moe  # noqa: E402

GQA_LEN, MLA_LEN = 20, 13      # shard 2 and shard 1 of 4 x 8 rows


def moe_cfg():
    return dataclasses.replace(
        reduced(get_config("deepseek-v2-lite-16b")),
        moe_capacity_factor=get_config(
            "deepseek-v2-lite-16b").moe_capacity_factor)


def inputs(seed=0):
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    cfg = moe_cfg()
    d, ffe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    sh = cfg.n_shared_experts * ffe
    x8 = rng.integers(-127, 128, size=(61, 32)).astype(np.int8)
    return {
        "topk_x": f32(64, 32), "topk_q": f32(5, 32),
        "odd_x": f32(61, 32), "i8_x": x8,
        "i8_scale": rng.uniform(0.001, 0.01, 61).astype(np.float32),
        "gqa_q": f32(4, 1, 4, 8), "gqa_k_new": f32(4, 1, 2, 8),
        "gqa_v_new": f32(4, 1, 2, 8), "gqa_kc": f32(4, 32, 2, 8),
        "gqa_vc": f32(4, 32, 2, 8),
        "mla_q_c": f32(4, 1, 4, 16), "mla_q_r": f32(4, 1, 4, 8),
        "mla_ckv_new": f32(4, 1, 16), "mla_krope_new": f32(4, 1, 8),
        "mla_ckv_c": f32(4, 32, 16), "mla_krope_c": f32(4, 32, 8),
        "moe_x": f32(2, 256, d),
        "moe_router": f32(d, E, scale=d ** -0.5),
        "moe_w1": f32(E, d, ffe, scale=d ** -0.5),
        "moe_w3": f32(E, d, ffe, scale=d ** -0.5),
        "moe_w2": f32(E, ffe, d, scale=ffe ** -0.5),
        "moe_sw1": f32(d, sh, scale=d ** -0.5),
        "moe_sw3": f32(d, sh, scale=d ** -0.5),
        "moe_sw2": f32(sh, d, scale=sh ** -0.5),
    }


def moe_params(a):
    return {"router": {"w": jnp.asarray(a["moe_router"])},
            "experts": {n: jnp.asarray(a[f"moe_{n}"])
                        for n in ("w1", "w2", "w3")},
            "shared": {n: {"w": jnp.asarray(a[f"moe_s{n}"])}
                       for n in ("w1", "w2", "w3")}}


def main(out_path):
    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh((2, 4), ("data", "model"))
    a = inputs()
    out = dict(a)

    v, i = sharded_mips_topk(jnp.asarray(a["topk_q"]),
                             jnp.asarray(a["topk_x"]), 7, mesh=mesh)
    out["topk_v"], out["topk_i"] = np.asarray(v), np.asarray(i)
    v, i = ShardedIndex(a["odd_x"], mesh).search(a["topk_q"], 7)
    out["odd_v"], out["odd_i"] = np.asarray(v), np.asarray(i)
    x8 = np.concatenate([a["i8_x"], np.zeros((3, 32), np.int8)])
    sc = np.concatenate([a["i8_scale"], np.ones(3, np.float32)])
    v, i = sharded_mips_topk(jnp.asarray(a["topk_q"]), jnp.asarray(x8), 7,
                             mesh=mesh, scales=jnp.asarray(sc), n_real=61)
    out["i8_v"], out["i8_i"] = np.asarray(v), np.asarray(i)

    o, kc, vc = gqa_decode_seq_sharded(
        *(jnp.asarray(a[f"gqa_{n}"]) for n in ("q", "k_new", "v_new", "kc",
                                               "vc")),
        jnp.asarray(GQA_LEN, jnp.int32), mesh=mesh, batch_axes=("data",))
    out["gqa_out"], out["gqa_kc2"], out["gqa_vc2"] = map(np.asarray,
                                                         (o, kc, vc))
    o, ckv, kr = mla_decode_seq_sharded(
        *(jnp.asarray(a[f"mla_{n}"]) for n in ("q_c", "q_r", "ckv_new",
                                               "krope_new", "ckv_c",
                                               "krope_c")),
        jnp.asarray(MLA_LEN, jnp.int32), 0.125, mesh=mesh,
        batch_axes=("data",))
    out["mla_out"], out["mla_ckv2"], out["mla_krope2"] = map(np.asarray,
                                                             (o, ckv, kr))

    cfg = moe_cfg()
    p = moe_params(a)
    y, aux = jax.jit(lambda p, x: moe_ffn_ep(cfg, p, x, mesh=mesh))(
        p, jnp.asarray(a["moe_x"]))
    out["moe_y"], out["moe_aux"] = np.asarray(y), np.asarray(aux)
    # the assignments each shard drops: its 64 local tokens (batch row b,
    # sequence quarter s) routed and ranked alone
    x = a["moe_x"]
    drops = 0
    for b in range(2):
        for s in range(4):
            x2d = jnp.asarray(x[b, s * 64:(s + 1) * 64])
            _, idx, _ = Moe.route(cfg, p, x2d)
            _, valid, _ = Moe.dispatch_slots(cfg, idx, 64)
            drops += int((~np.asarray(valid)).sum())
    out["moe_drops"] = np.asarray(drops)
    np.savez(out_path, **out)
    print("ok", drops)


if __name__ == "__main__":
    main(sys.argv[1])
