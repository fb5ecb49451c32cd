"""One process per host: the ``pod`` axis of training across hosts.

The reference has no such module. It runs a TPU pod's hosts as one
program: JAX's multi-controller runtime spans the (pod 2, data 16, model
16) mesh over every host, and XLA inserts the gradient all-reduce over
``pod`` (``src/repro/launch/mesh.py``). torch has no such runtime, so this
module takes that role. Each host runs one process, which drives its
local (data, model) mesh on one controller (``distributed/sharding.py``),
and the processes form a ``torch.distributed`` group whose ranks are the
pod indices. The ``pod`` axis is pure data parallelism, the reference's
stated role for it:

* params and AdamW state are replicated over pods (FSDP runs over the
  local ``data`` axis only, where the reference's rule shards over
  ``("pod", "data")``: the two differ in memory per host, not in values);
* pod ``p`` takes rows ``[p::n_pods]`` of each global microbatch
  (``pod_rows``; the data cursor stays the step);
* the loss is normalised over the valid labels of the whole global
  microbatch and the MoE load-balance loss reads the global routing
  statistics (``pod_sum``/``pod_mean``: the value is the sum over pods,
  the gradient reaches the local term only, so that the summed gradients
  are the global batch's);
* between backward and optimizer the f32 gradients are summed over the
  group in flat buckets (``all_reduce_grads``); every rank then runs the
  same compression and AdamW on the same numbers and holds bit-identical
  params (``replicas_identical`` checks it);
* rank 0 writes the checkpoint in the reference's mesh-agnostic layout
  while the others wait at a barrier, and every rank restores from it
  onto its local mesh.

A host's pods split its cards in rank order (``pod_cards``,
``local_devices``), as the one-controller (pod, data, model) mesh does;
``spawn`` starts the pods of one host as processes of their own.

The process layer is active when a process group is initialised
(``init``): ``training/train.py`` and ``distributed/train_parallel.py``
read ``n_pods()``, which is 1 without one. Only ``all_reduce`` and
``broadcast`` cross processes: they are the two collectives that ``gloo``
implements on CUDA tensors, and NCCL refuses two ranks on one card, so a
one-card run of two pods uses ``gloo``.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import parts
from repro_torch.launch import costs
from repro_torch.models.convert import tree_leaves

BUCKET_BYTES = 256 << 20     # one all-reduce per this many gradient bytes
COLLECTIVE_TIMEOUT_S = 1800  # a collective that waits longer raises

# what the gradient all-reduces cost in this process: seconds, bytes, calls
stats = {"all_reduce_s": 0.0, "all_reduce_bytes": 0, "all_reduces": 0}


def init(backend, init_method=None, rank=None, world_size=None):
    """Join the pod group with ``backend`` ("nccl" or "gloo"; neither is
    chosen for the caller). torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) are read when set;
    otherwise ``init_method`` (a ``file://`` rendezvous needs no network),
    ``rank`` and ``world_size`` are required. A collective that waits past
    ``COLLECTIVE_TIMEOUT_S`` raises. Raises when the backend cannot start
    (NCCL without a card)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device; pass "
                           "backend='gloo' for CPU processes")
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("no rendezvous: pass init_method (e.g. "
                             "'file:///path/rdv') or run under torchrun")
        init_method = "env://"
    if rank is None or world_size is None:
        raise ValueError("rank and world_size are needed outside torchrun")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def n_pods() -> int:
    return dist.get_world_size() if active() else 1


def pod_index() -> int:
    return dist.get_rank() if active() else 0


def barrier():
    if active():
        dist.barrier()


def shutdown():
    if active():
        dist.destroy_process_group()


def pod_cards(n_cards, local_rank, local_pods, backend):
    """The cards (indices) that pod ``local_rank`` of the ``local_pods`` on
    one host drives, out of the host's ``n_cards``: a block of
    ``n_cards / local_pods`` each, in rank order, as the one-controller
    (pod, data, model) mesh splits them (``launch/mesh.py``). Fewer cards
    than pods put ``local_pods / n_cards`` pods on each card, which only
    ``gloo`` allows: NCCL refuses two ranks on one card."""
    if n_cards >= local_pods:
        if n_cards % local_pods:
            raise ValueError(f"{n_cards} cards do not split over "
                             f"{local_pods} pods")
        k = n_cards // local_pods
        return list(range(local_rank * k, (local_rank + 1) * k))
    if backend == "nccl":
        raise ValueError(f"{local_pods} pods on {n_cards} card(s) would "
                         "share a card, which NCCL refuses: pass "
                         "backend 'gloo'")
    if not n_cards or local_pods % n_cards:
        raise ValueError(f"{local_pods} pods do not share {n_cards} "
                         "card(s) evenly")
    return [local_rank * n_cards // local_pods]


def local_devices(device_type, backend):
    """This pod's devices after ``init``: ``[cpu]``, or its ``pod_cards``
    of this host's cards (its local rank and the pods on this host read
    from torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, else the group's
    rank and size: one host), the first made the current card."""
    if device_type != "cuda":
        return [torch.device(device_type)]
    env = os.environ
    cards = pod_cards(torch.cuda.device_count(),
                      int(env.get("LOCAL_RANK", pod_index())),
                      int(env.get("LOCAL_WORLD_SIZE", n_pods())), backend)
    torch.cuda.set_device(cards[0])
    return [torch.device("cuda", c) for c in cards]


def spawn(cmd, n, deadline_s, logdir, env=None):
    """Run ``n`` copies of ``cmd``, copy ``r`` with ``--pod-rank r``
    appended and its output in ``logdir/rank{r}.log``, and wait for all.
    A copy that fails, or a run past ``deadline_s`` seconds (None: no
    deadline), ends the others and raises with the failing copy's log.
    Returns the logs."""
    logdir = Path(logdir)
    logs = [logdir / f"rank{r}.log" for r in range(n)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [*cmd, "--pod-rank", str(r)], stdout=f,
                stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + (float("inf") if deadline_s is None
                                      else deadline_s)
    try:
        while any(p.poll() is None for p in procs) and \
                time.perf_counter() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = [log.read_text() for log in logs]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        r = next((r for r in bad if r not in late), bad[0])
        why = (f"exited with {procs[r].returncode}" if r not in late else
               f"was still running after {deadline_s} s")
        raise RuntimeError(f"pod rank {r} {why}:\n{texts[r][-4000:]}")
    return texts


def pod_rows(batch):
    """This pod's rows ``[p::n_pods]`` of a global batch (dim 1 of
    ``mrope_positions`` (3, B, S), dim 0 of every other leaf)."""
    p, n = pod_index(), n_pods()
    if n == 1:
        return batch
    return {k: v[:, p::n] if k == "mrope_positions" else v[p::n]
            for k, v in batch.items()}


class _PodSum(torch.autograd.Function):
    """The sum over pods; the backward passes the gradient to the local
    term alone (the other pods' terms are constants here, and their
    gradients reach their own params, which ``all_reduce_grads`` adds)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        _census(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def _census(t):
    """Report one all-reduce of ``t`` over the pods to an active cost
    counter (``launch/costs.py``)."""
    c = costs.active()
    if c is not None:
        c.census.record("all-reduce", "pod", n_pods(), 2 * costs.nbytes(t))


def pod_sum(x):
    """The sum of ``x`` over pods (``x`` itself without a group)."""
    return _PodSum.apply(x) if n_pods() > 1 else x


def pod_mean(x):
    return pod_sum(x) / n_pods() if n_pods() > 1 else x


def all_reduce_grads(grads):
    """Sum a gradient tree (tensors or ``Sharded`` leaves, f32) over pods
    in place: every position's tensor, packed into flat buckets of about
    ``BUCKET_BYTES`` per device. Returns ``grads``; the seconds and bytes
    add up in ``stats``."""
    if n_pods() == 1:
        return grads
    t0 = time.perf_counter()
    tensors = [t for g in tree_leaves(grads) for t in parts(g)]
    buckets, sizes = {}, {}
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce_grads sums f32 gradients, got "
                            f"{t.dtype}")
        key = t.device
        if not buckets.get(key) or \
                sizes[key] + t.numel() * 4 > BUCKET_BYTES:
            buckets.setdefault(key, []).append([])
            sizes[key] = 0
        buckets[key][-1].append(t)
        sizes[key] += t.numel() * 4
    for groups in buckets.values():
        for group in groups:
            if len(group) == 1 and group[0].is_contiguous():
                flat = group[0]          # a leaf past the bucket size alone
                dist.all_reduce(flat)
                _census(flat)
            else:
                flat = torch.cat([t.reshape(-1) for t in group])
                dist.all_reduce(flat)
                _census(flat)
                off = 0
                for t in group:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()
            stats["all_reduce_bytes"] += flat.numel() * 4
            stats["all_reduces"] += 1
    if tensors and tensors[0].is_cuda:
        torch.cuda.synchronize()
    stats["all_reduce_s"] += time.perf_counter() - t0
    return grads


_CHUNK = 1 << 24


def checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over ``t``'s bits (plain and position-weighted), on
    its device: equal tensors give equal checksums, and a changed bit
    changes them."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.detach().contiguous().reshape(-1).view(ints[t.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), _CHUNK):
        b = flat[i:i + _CHUNK].to(torch.int64)
        w = torch.arange(i, i + b.numel(), device=t.device) % 65521 + 1
        out[0] += b.sum()
        out[1] += (b * w).sum()
    return out


def replicas_identical(tree) -> bool:
    """Whether every pod holds bit for bit rank 0's ``tree`` (a per-leaf
    ``checksum`` of each position's tensor, broadcast from rank 0). True
    on every rank only when it holds on all."""
    ts = [t for leaf in tree_leaves(tree) for t in parts(leaf)]
    dev = next((t.device for t in ts if t.is_cuda), torch.device("cpu"))
    mine = torch.stack([checksum(t).to(dev) for t in ts])
    if n_pods() == 1:
        return True
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    bad = torch.tensor([int(not torch.equal(ref, mine))],
                       device=mine.device)
    dist.all_reduce(bad)
    return int(bad.item()) == 0
