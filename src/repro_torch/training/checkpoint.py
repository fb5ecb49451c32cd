"""Asynchronous checkpoints in the JAX package's on-disk layout (its
``training/checkpoint.py``), so a checkpoint written by either package
restores in the other.

Layout (step_NNNNNNNN/):
  meta.json          — step, the flat key list with shapes and dtypes,
                       ``extra`` (e.g. a data cursor)
  <flat-key>.npy     — one array per leaf, the key's "/" written as "__"

Keys are the reference's pytree paths: a layer stack the port keeps as a
list of per-layer dicts is written as the reference's stacked leaves
(``params/blocks/attn/wq/w`` of shape (L, d_in, d_out)); a bf16 leaf as
its raw 2-byte values with dtype "bfloat16" in the meta, which is what
the reference's ``np.save`` of an ``ml_dtypes.bfloat16`` array writes.

* **Async** — ``save`` copies every leaf to host memory now (a device to
  host copy) and writes to disk on a background thread, so the train loop
  goes on; ``wait()`` joins it, and every ``save`` waits for the last.
* **Atomic** — a checkpoint is written to ``<dir>.tmp`` and renamed with
  ``os.replace``; a crash mid-write leaves the previous checkpoint, and
  ``steps``/``latest_step`` believe only directories with a ``meta.json``
  and no ``.tmp`` suffix.
* ``keep`` — the newest ``keep`` checkpoints stay, older ones are removed.
* **Mesh-agnostic** — a ``Sharded`` leaf is written as its global array
  (one replica of each block), so the files do not depend on the mesh
  they came from; ``restore(shardings=)`` lays every leaf out on any
  mesh (the elastic re-shard: from one device, from another mesh shape,
  or from a checkpoint the reference wrote).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import Sharded, place
from repro_torch.models.convert import params_from_jax, to_numpy, to_tensor


def _host(node):
    """A state tree as the reference's numpy pytree: tensors copied to the
    host, a list of layer dicts stacked into one dict of (L, ...) arrays."""
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        items = [_host(v) for v in node]
        if items and isinstance(items[0], dict):
            return _stack(items)
        return items
    if isinstance(node, Sharded):      # assembled on its mesh, one copy out
        return to_numpy(node.full())
    if isinstance(node, torch.Tensor):
        return to_numpy(node)
    return np.array(node)


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(path + (str(i),), v)
        else:
            flat["/".join(path)] = node

    rec((), tree)
    return flat


def _unflatten(flat: Dict[str, Any]):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype.kind == "V" and a.dtype.itemsize == 2 \
        else str(a.dtype)


def to_port(tree, device="cuda", copy=True):
    """A restored tree (the reference's layout) as the port's: each
    params-shaped subtree (a dict with an ``embed`` entry: the params,
    AdamW's master, m and v, the compression error state) through
    ``params_from_jax``, every other array as a tensor on ``device``
    (``copy=False``: CPU tensors sharing the arrays' memory)."""
    if isinstance(tree, dict):
        if "embed" in tree:
            return params_from_jax(tree, device=device, copy=copy)
        return {k: to_port(v, device, copy) for k, v in tree.items()}
    return to_tensor(tree, device, copy)


class Checkpointer:
    def __init__(self, root, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save --------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[dict] = None,
             blocking: bool = False):
        """state: a tree of tensors or numpy arrays (dicts, lists). The
        device to host copy happens NOW; the disk write on a background
        thread."""
        self.wait()
        host = _flatten(_host(state))
        meta = {"step": step, "extra": extra or {},
                "keys": {k: [list(a.shape), _dtype_name(a)]
                         for k, a in host.items()}}

        def write():
            final = self.root / f"step_{step:08d}"
            tmp = Path(str(final) + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for k, a in host.items():
                np.save(tmp / (k.replace("/", "__") + ".npy"), a)
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def steps(self):
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None, device=None,
                shardings=None):
        """Returns (state, meta): the reference's numpy pytree, with
        ``device`` the port's tensors there (``to_port``), or with
        ``shardings`` (a tree of ``sharding.NamedSharding`` of the port's
        state, on any mesh; None leaves stay on the host) the port's
        state laid out on that mesh (``sharding.place``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.root}")
        d = self.root / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        flat = {k: np.load(d / (k.replace("/", "__") + ".npy"))
                for k in meta["keys"]}
        state = _unflatten(flat)
        if shardings is not None:
            state = place(to_port(state, "cpu", copy=False), shardings)
        elif device is not None:
            state = to_port(state, device)
        return state, meta
