"""Device meshes of the port (counterpart of the JAX package's
``launch/mesh.py``).

A ``Mesh`` is an ndarray of ``torch.device``s with named axes, as JAX's
is: ``.devices``, ``.axis_names`` and ``.shape`` (axis name -> size). One
Python process drives every device of it (``distributed/sharding.py``
runs a local function per shard and the collectives as tensor ops across
the shard list), as JAX's single controller does. ``AbstractMesh`` holds
the axis names and sizes alone, which is all the sharding rules read.

Axis roles (as in the reference):
  pod   — outermost data parallelism: one process per host in a
          ``torch.distributed`` group (``distributed/multihost.py``), or
          an axis of a one-controller mesh
  data  — batch sharding, FSDP
  model — tensor parallel (heads, MLP, vocab), expert parallel (MoE),
          KV-sequence parallel (seq-sharded decode), index-row parallel
          (the sharded MIPS tier)

A mesh may name one device more than once only when the caller lists the
devices (``make_mesh(..., devices=[...])``): tests run eight shards on
the CPU, and a one-card run puts four shards on ``cuda:0``.
``make_local_mesh`` takes distinct devices and raises when there are too
few. Every device of a mesh has one type: a mesh that mixes ``cuda`` and
``cpu`` raises.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed import multihost


class AbstractMesh:
    """Axis names and sizes, no devices (``jax.sharding.AbstractMesh``'s
    counterpart): what ``distributed/sharding.py``'s rules need."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names) \
                or any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair one positive size with each distinct "
                             "name")
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A named-axis array of ``torch.device``s of one type."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devs = np.empty(np.shape(devices), dtype=object)
        for pos in np.ndindex(devs.shape):
            devs[pos] = torch.device(devices[pos])
        super().__init__(devs.shape, axis_names)
        types = sorted({d.type for d in devs.flat})
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {types}:"
                             " a shard never runs on another device than "
                             "the mesh's")
        self.devices = devs

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``. ``devices`` (row-major
    over ``shape``) may name one device more than once; by default the
    first ``prod(shape)`` distinct CUDA devices, as ``make_local_mesh``
    takes them."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        devices = _distinct("cuda", math.prod(shape))
    if len(devices) != math.prod(shape):
        raise ValueError(f"{len(devices)} devices for a mesh of shape "
                         f"{shape}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def _distinct(device: str, n: int):
    kind = torch.device(device).type
    have = torch.cuda.device_count() if kind == "cuda" else 1
    if n > have:
        raise ValueError(f"a mesh of {n} distinct {kind} devices, but "
                         f"{have} are visible; list the devices to "
                         "make_mesh to repeat one")
    return [torch.device(kind, i) if kind == "cuda" else torch.device(kind)
            for i in range(n)]


def make_local_mesh(model: int = 1, data: int = 1,
                    device: str = "cuda") -> Mesh:
    """A (data, model) mesh over distinct visible devices of ``device``'s
    type (the CPU counts as one device). Raises when there are too few:
    it never repeats a device."""
    return make_mesh((data, model), ("data", "model"),
                     _distinct(device, data * model))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The training mesh of one node: (data 1, model n) over its n visible
    cards (or ``devices``, which may repeat one), the counterpart of a
    pod's 16-chip model axis on one NVLink node.

    ``multi_pod`` (the reference's (pod 2, data 16, model 16) across
    hosts): inside a pod group (``distributed/multihost.py``, one process
    per host) this is the rank's local (data 1, model n) mesh, and the
    ``pod`` axis, of the group's size, is the group itself. In one
    process it is the (pod 2, data 1, model n / 2) mesh on one controller
    over the devices, as the reference's dry run builds its mesh on one
    host."""
    if devices is None:
        devices = _distinct("cuda", torch.cuda.device_count())
    if not devices:
        raise ValueError("no CUDA device is visible for the training mesh; "
                         "list the devices (e.g. devices=['cpu'])")
    if multi_pod and not multihost.active():
        if len(devices) % 2:
            raise ValueError(f"a (pod 2, data 1, model n) mesh needs an even "
                             f"number of devices, got {len(devices)}")
        return make_mesh((2, 1, len(devices) // 2), ("pod", "data", "model"),
                         devices)
    return make_mesh((1, len(devices)), ("data", "model"), devices)


def batch_axes_of(mesh) -> tuple:
    """Axes a global batch dim shards over (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def n_batch_shards(mesh) -> int:
    n = 1
    for a in batch_axes_of(mesh):
        n *= mesh.shape[a]
    return n
