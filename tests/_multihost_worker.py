"""One pod of the two-process training tests (``tests/
test_torch_multihost.py``), run as

    python tests/_multihost_worker.py JOB --pod-rank RANK

``JOB`` is a ``torch.save``d dict: the config, the params, the global
batch, the ``RunCfg`` knobs of the local mesh, the rendezvous and the
output directory. The pod joins a two-rank ``gloo`` group, trains on its
rows ``[rank::2]`` of the batch on its own (data 1, model 2) CPU mesh
(``make_production_mesh(multi_pod=True)`` inside the group) and records
into ``out/result{rank}.pt``: one step's loss and all-reduced gradients,
then two AdamW steps without and with gradient compression, whether the
ranks' params and optimizer state were identical after each step, and the
final params. Rank 0 writes the uncompressed run's checkpoint. Imports
torch and the port only.
"""
import sys
from pathlib import Path

import torch

from repro_torch.distributed import multihost
from repro_torch.distributed import sharding as Sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training import checkpoint as CK
from repro_torch.training import compression as GC
from repro_torch.training import optimizer as O
from repro_torch.training import train as T


def compress(grads, opt_state):
    dq, err = GC.compress_grads(grads, opt_state["grad_err"])
    return dq, dict(opt_state, grad_err=err)


def main(job_path, rank):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    out = Path(job["out"])
    multihost.init("gloo", job["init"], rank, 2)
    mesh = make_production_mesh(
        multi_pod=True, devices=multihost.local_devices("cpu", "gloo") * 2)
    cfg = job["cfg"]
    run = SP.make_runcfg(cfg, job["shape"], mesh, **job["run_kw"])
    pshard = Sh.param_shardings(job["params"], mesh, cfg)
    batch = multihost.pod_rows(job["batch"])
    res = {"mesh": dict(mesh.shape), "rows": batch["tokens"].shape[0]}

    params = Sh.place(job["params"], pshard)
    loss, met, grads = T.accumulate(T.make_grad_fn(cfg, run), params, batch)
    multihost.all_reduce_grads(grads)
    res.update(loss=float(loss), moe_aux=float(met["moe_aux"]),
               grads=Sh.gather(grads))

    for name, fn in (("plain", None), ("compressed", compress)):
        params = Sh.place(job["params"], pshard)
        opt = O.init(params)
        if fn is not None:
            opt["grad_err"] = GC.init_error_state(params)
        step = T.make_train_step(cfg, run, job["ocfg"], compress=fn)
        same = []
        for _ in range(2):
            params, opt, m = step(params, opt, batch)
            same.append(multihost.replicas_identical(
                {"params": params, "opt": opt}))
        res[name] = {"same": same, "params": Sh.gather(params),
                     "grad_norm": float(m["grad_norm"])}
        if name == "plain" and rank == 0:
            CK.Checkpointer(out / "ck").save(
                2, {"params": params, "opt": opt}, blocking=True)
    multihost.barrier()
    res["all_reduces"] = multihost.stats["all_reduces"]
    torch.save(res, out / f"result{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    assert sys.argv[2] == "--pod-rank", sys.argv
    main(sys.argv[1], int(sys.argv[3]))
