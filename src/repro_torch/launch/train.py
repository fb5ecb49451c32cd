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
shards on one card).

``--multipod`` trains over the reference's ``pod`` axis with one process
per pod (``distributed/multihost.py``): under torchrun (``RANK``,
``WORLD_SIZE`` set) each process joins the group; otherwise ``--pods P``
(default 2) starts P processes of this launcher on this host, joined by a
``file://`` rendezvous, and waits for them. The pods of a host split
its n cards in rank order, pod p taking cards [p*n/P, (p+1)*n/P) as the
one-controller (pod, data, model) mesh does; each process builds its
``--mesh D,M`` local mesh over its cards (by default a (data 1, model
n/P) mesh), takes rows ``[p::P]`` of each global batch, and sums its
gradients over the pods. ``--backend`` is ``nccl`` on ``cuda`` and
``gloo`` on ``cpu`` unless given; a backend that cannot start raises, and
so do pods that would share a card under NCCL, which refuses two ranks on
one card (more pods than cards take ``--backend gloo``). Rank 0 prints and
writes the checkpoints; ``--smoke`` keeps the reduced config and batch:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --multipod --pods 2 --mesh 1,2 --device cpu --steps 3

Checkpoints are written asynchronously every ``--ckpt-every`` steps in the
reference's mesh-agnostic layout, and a run restarted with the same
``--ckpt`` resumes from the latest one, restored onto the current mesh
whatever mesh wrote it.
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.distributed import multihost
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as GC
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import train as T


def _mesh(args, backend=None):
    """The mesh this process drives (the pod axis, if any, is its
    group): a pod's mesh lies on its own cards (``multihost.pod_cards``)."""
    devices = None if torch.device(args.device).type == "cuda" else \
        [args.device]
    if args.multipod:
        devices = multihost.local_devices(torch.device(args.device).type,
                                          backend)
    if args.mesh:
        shape = tuple(int(s) for s in args.mesh.split(","))
        n = shape[0] * shape[1]
        return make_mesh(shape, ("data", "model"),
                         ((devices or [args.device]) * n)[:n])
    return make_production_mesh(multi_pod=args.multipod, devices=devices)


def _spawn_pods(args, argv):
    """Start ``--pods`` processes of this launcher as the ranks of a
    ``file://`` rendezvous and wait for them (``multihost.spawn``); rank
    0's output is printed."""
    tmp = Path(tempfile.mkdtemp(prefix="pods-"))
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        logs = multihost.spawn(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--init-method", f"file://{tmp / 'rendezvous'}"], args.pods,
            None, tmp, env=env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(logs[0], end="")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch on one device")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--multipod", action="store_true",
                    help="one process per pod, gradients summed over them")
    ap.add_argument("--pods", type=int, default=2,
                    help="--multipod outside torchrun: processes to start")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the pod group's backend (nccl on cuda, gloo on "
                    "cpu by default)")
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh", default=None,
                    help="D,M: a (data, model) mesh over --device repeated")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    argv = list(sys.argv[1:] if argv is None else argv)

    cfg = get_config(args.arch)
    pods, backend = 1, None
    if args.multipod:
        kind = torch.device(args.device).type
        backend = args.backend or ("nccl" if kind == "cuda" else "gloo")
        if backend == "nccl" and kind != "cuda":
            raise ValueError(f"--backend nccl needs --device cuda, got "
                             f"{args.device!r}: pass --backend gloo")
        if args.init_method is None and "RANK" not in os.environ:
            if kind == "cuda":      # the pods' cards, checked before spawning
                multihost.pod_cards(torch.cuda.device_count(), 0, args.pods,
                                    backend)
            return _spawn_pods(args, argv)
        multihost.init(backend, args.init_method, args.pod_rank,
                       None if args.init_method is None else args.pods)
        pods = multihost.n_pods()
    if args.smoke:
        cfg = reduced(cfg)
    if args.smoke and not args.multipod:
        B, S = args.batch or 4, args.seq or 64
        mesh = None
        run = M.RunCfg(attn_impl="naive", remat=False)
        accum = args.accum or 1
    else:
        mesh = _mesh(args, backend)
        B = args.batch or (4 if args.smoke else
                           SHAPES["train_4k"].global_batch)
        S = args.seq or (64 if args.smoke else SHAPES["train_4k"].seq_len)
        if B % pods:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"over {pods} pods")
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S,
                                    global_batch=B // pods)
        run = SP.train_runcfg(args.arch, cfg, shape, mesh)
        accum = args.accum or SP.train_accum(args.arch, mesh, B // pods)
    dev = mesh.devices.flat[0] if mesh is not None else \
        torch.device(args.device)
    shape_of = mesh and dict(mesh.shape)
    if pods > 1:
        shape_of = dict(pod=pods, **shape_of)
    rank0 = multihost.pod_index() == 0
    log = print if rank0 else (lambda *a, **k: None)
    log(f"train {cfg.name}: params~{cfg.param_count() / 1e9:.2f}B "
        f"batch={B}x{S} accum={accum} mesh={shape_of} device={dev}")

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
        log(f"resumed at step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        b = {k: torch.from_numpy(v).long().to(dev)
             for k, v in multihost.pod_rows(data.batch(i)).items()}
        params, opt, m = step_fn(params, opt, b)
        if (i + 1) % 10 == 0 or i == start:
            log(f"step {i + 1} loss={float(m['loss']):.4f} "
                f"({(time.time() - t0) / (i - start + 1):.2f}s/step)")
        if ck and rank0 and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": opt})
    if ck and rank0:
        ck.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    if pods > 1:
        same = multihost.replicas_identical({"params": params, "opt": opt})
        log(f"pods={pods} replicas identical={same} all-reduce "
            f"{multihost.stats['all_reduce_s']:.2f}s")
        multihost.barrier()
        multihost.shutdown()
        if not same:
            raise RuntimeError("the pods' params diverged")
    log("done")


if __name__ == "__main__":
    main()
