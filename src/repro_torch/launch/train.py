"""Training launcher: any arch on one device or a mesh (the port of the JAX
package's ``launch/train.py``; CUDA unless ``--device cpu``).

Reduced config on one device, CPU-runnable:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --device cpu --steps 20

Production posture: the reference's ``train_4k`` shape (256 x 4096 tokens
unless ``--batch``/``--seq`` say otherwise) on a ("data", "model") mesh
over the node's cards (``make_production_mesh``), with ``make_runcfg``'s
layout (heads and MLP split over model, FSDP over data, expert-parallel
MoE, remat), the accumulation of ``specs.train_accum``, params and AdamW
state placed by the sharding rules:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 1000 --ckpt runs/llama32 [--compress]

``--mesh D,M`` lays a (data D, model M) mesh over ``--device`` repeated
(the tests run ``--device cpu --mesh 2,4``; ``--mesh 2,2`` puts four
shards on one card). ``--multipod`` (the reference's pod axis, across
hosts) raises: one process drives one node (ROADMAP A14).

Checkpoints are written asynchronously every ``--ckpt-every`` steps in the
reference's mesh-agnostic layout, and a run restarted with the same
``--ckpt`` resumes from the latest one, restored onto the current mesh
whatever mesh wrote it.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as GC
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import train as T


def _mesh(args):
    if args.mesh:
        shape = tuple(int(s) for s in args.mesh.split(","))
        n = shape[0] * shape[1]
        return make_mesh(shape, ("data", "model"), [args.device] * n)
    if torch.device(args.device).type == "cuda":
        return make_production_mesh()
    return make_production_mesh(devices=[args.device])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch on one device")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="D,M: a (data, model) mesh over --device repeated")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.multipod:
        make_production_mesh(multi_pod=True)      # raises: ROADMAP A14
    if args.smoke:
        cfg = reduced(cfg)
        B, S = args.batch or 4, args.seq or 64
        mesh = None
        run = M.RunCfg(attn_impl="naive", remat=False)
        accum = args.accum or 1
    else:
        mesh = _mesh(args)
        B = args.batch or SHAPES["train_4k"].global_batch
        S = args.seq or SHAPES["train_4k"].seq_len
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S,
                                    global_batch=B)
        run = SP.train_runcfg(args.arch, cfg, shape, mesh)
        accum = args.accum or SP.train_accum(args.arch, mesh, B)
    dev = mesh.devices.flat[0] if mesh is not None else \
        torch.device(args.device)
    print(f"train {cfg.name}: params~{cfg.param_count() / 1e9:.2f}B "
          f"batch={B}x{S} accum={accum} "
          f"mesh={mesh and dict(mesh.shape)} device={dev}")

    compress = None
    if args.compress:
        def compress(grads, opt_state):
            dq, err = GC.compress_grads(grads, opt_state["grad_err"])
            return dq, dict(opt_state, grad_err=err)

    ocfg = O.AdamWCfg(total_steps=args.steps)
    step_fn = T.make_train_step(cfg, run, ocfg, accum=accum,
                                compress=compress)
    data = D.SyntheticLMData(cfg.vocab_size, B, S)

    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    pshard = None
    if mesh is not None:
        pshard = Sh.param_shardings(params, mesh, cfg)
        params = Sh.place(params, pshard)
    opt = O.init(params)
    if args.compress:
        opt["grad_err"] = GC.init_error_state(params)

    ck = CK.Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ck and ck.latest_step() is not None:
        if mesh is not None:
            oshard = dict(O.state_shardings(pshard), grad_err=pshard)
            state, meta = ck.restore(shardings={"params": pshard,
                                                "opt": oshard})
        else:
            state, meta = ck.restore(device=dev)
            state["opt"]["step"] = state["opt"]["step"].cpu()
        params, opt = state["params"], state["opt"]
        if args.compress and "grad_err" not in opt:
            opt["grad_err"] = GC.init_error_state(params)
        start = meta["step"]
        print(f"resumed at step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        b = {k: torch.from_numpy(v).long().to(dev)
             for k, v in data.batch(i).items()}
        params, opt, m = step_fn(params, opt, b)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i + 1} loss={float(m['loss']):.4f} "
                  f"({(time.time() - t0) / (i - start + 1):.2f}s/step)")
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": opt})
    if ck:
        ck.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print("done")


if __name__ == "__main__":
    main()
