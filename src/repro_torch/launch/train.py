"""Training launcher on one device (the port of the JAX package's
``launch/train.py``; CUDA unless ``--device cpu``).

Reduced config, CPU-runnable:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --device cpu --steps 20

Full config on one card (bf16 params, f32 AdamW state, blockwise
attention):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --batch 4 --seq 256 --steps 100 --ckpt runs/ck [--compress]

Checkpoints are written asynchronously every ``--ckpt-every`` steps in the
reference's layout, and a run restarted with the same ``--ckpt`` resumes
from the latest one. The reference's production shape (``train_4k``: 256 x
4096 tokens) and ``--multipod`` run on a device mesh, which is the
distributed slice of the port (ROADMAP A10b), not this launcher.
"""
import argparse
import time

import torch

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as GC
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import train as T

MESH_MSG = ("needs a device mesh: the distributed half of training "
            "(torch.distributed, ROADMAP A10b) is not ported")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.multipod:
        raise NotImplementedError(f"--multipod {MESH_MSG}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
        B, S = args.batch or 4, args.seq or 64
        run = M.RunCfg(attn_impl="naive")
    else:
        if args.batch is None or args.seq is None:
            shape = SHAPES["train_4k"]
            raise NotImplementedError(
                f"the production shape {shape.name} ({shape.global_batch} x "
                f"{shape.seq_len} tokens) {MESH_MSG}; pass --batch and "
                "--seq to train the full config on one device")
        B, S = args.batch, args.seq
        run = M.RunCfg(attn_impl="blockwise")
    accum = args.accum or 1
    dev = torch.device(args.device)
    print(f"train {cfg.name}: params~{cfg.param_count() / 1e9:.2f}B "
          f"batch={B}x{S} accum={accum} device={dev}")

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
    opt = O.init(params)
    if args.compress:
        opt["grad_err"] = GC.init_error_state(params)

    ck = CK.Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ck and ck.latest_step() is not None:
        state, meta = ck.restore(device=dev)
        params, opt = state["params"], state["opt"]
        opt["step"] = opt["step"].cpu()
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
