"""The JAX package's mesh training on eight forced host devices: writes what
``tests/test_torch_mesh_train.py`` holds the port to.

    python tests/_dist_train_reference.py OUT_DIR

* ``OUT_DIR/mesh_step.json``: the reference's train-time ``lm_loss``
  gradient, jitted over params and a batch placed on a (data 2, model 4)
  mesh with ``make_runcfg``'s knobs (the launcher's production path) for
  the reduced qwen3-1.7b and deepseek-v2-lite-16b: whether it ran, and its
  error when it did not (JAX 0.9 refuses the embedding gather under the
  mesh's explicit axes), beside the one-device loss.
* ``OUT_DIR/ckpt``: a checkpoint the reference saved from that mesh (the
  reduced qwen3-1.7b's f32 params and AdamW state after ``O.init``), and
  ``OUT_DIR/ckpt_ok.json``: whether the reference restores it onto a
  (data 4, model 2) mesh bit for bit (``tests/dist_checks.py`` check 6).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro.distributed import sharding as Sh  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.training import checkpoint as CK  # noqa: E402
from repro.training import optimizer as O  # noqa: E402

B, S = 8, 32


def mesh_step(arch, mesh):
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=2)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)),
                            jnp.int32) for k in ("tokens", "labels")}
    run = SP.make_runcfg(cfg, ShapeConfig("train", S, B, "train"), mesh,
                         attn_impl="naive")
    grad = jax.value_and_grad(
        lambda p, b, r: M.lm_loss(cfg, p, b, r)[0])
    want = float(grad(params, batch, M.RunCfg(attn_impl="naive",
                                              remat=False))[0])
    placed = jax.tree_util.tree_map(jax.device_put, params,
                                    Sh.param_shardings(params, mesh, cfg))
    bb = jax.tree_util.tree_map(jax.device_put, batch,
                                Sh.batch_shardings(batch, mesh))
    try:
        loss = float(jax.jit(lambda p, b: grad(p, b, run))(placed, bb)[0])
        return {"ran": True, "loss": loss, "one_device_loss": want}
    except Exception as e:           # the failure is the finding
        return {"ran": False, "error": type(e).__name__,
                "message": str(e)[:400], "one_device_loss": want}


def main(out):
    assert len(jax.devices()) == 8, jax.devices()
    out = Path(out)
    mesh = make_mesh((2, 4), ("data", "model"))
    res = {a: mesh_step(a, mesh) for a in ("qwen3-1.7b",
                                            "deepseek-v2-lite-16b")}
    (out / "mesh_step.json").write_text(json.dumps(res))

    cfg = reduced(get_config("qwen3-1.7b"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    placed = jax.tree_util.tree_map(jax.device_put, params,
                                    Sh.param_shardings(params, mesh, cfg))
    CK.Checkpointer(out / "ckpt").save(
        1, {"params": placed, "opt": O.init(placed)}, blocking=True)
    mesh_b = make_mesh((4, 2), ("data", "model"))
    specs = Sh.param_specs(params, mesh_b, cfg)
    state, _ = CK.Checkpointer(out / "ckpt").restore(shardings={
        "params": Sh.param_shardings(params, mesh_b, cfg),
        "opt": jax.tree_util.tree_map(
            lambda s: jax.sharding.NamedSharding(mesh_b, s),
            O.state_specs(specs))})
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(params),
        jax.tree_util.tree_leaves(state["params"])))
    (out / "ckpt_ok.json").write_text(json.dumps({"restored_equal": same}))
    print("ok", {a: r["ran"] for a, r in res.items()}, same)


if __name__ == "__main__":
    main(sys.argv[1])
