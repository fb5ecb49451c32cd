"""FLOP, byte, memory and collective counts of the port's programs: the
counterpart of the JAX package's ``launch/costs.py``.

The reference walks a jaxpr, multiplying a scan body's costs by its
trip count, because XLA's own analysis visits a loop body once. The port
runs eagerly: every op of every layer really executes, so a
``TorchDispatchMode`` (``Counter``) sees each aten op as it runs, on any
device, the meta device included (shapes only, nothing computed), and
the backward, ``torch.utils.checkpoint``'s recompute included, is
counted as it runs.

Per op (``Counter.by_op`` keeps each op's calls, FLOPs and bytes):

* ``dot_flops``: the products, by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention ops;
  ``einsum`` and ``matmul`` reach the dispatcher as these), and the
  kernels' own credit (below), each kept by the dtype of its inputs;
* ``flops``: the products plus the reference's conventions: 1 per output
  element for an elementwise op, 1 per input element for a reduction, 5
  for a softmax (its max, subtract, exp, sum and divide), 10 per element
  for sort and top-k; comparisons, casts, copies, gathers and scatters
  cost none;
* ``bytes``: what the eager program moves: each op that is not a view
  reads its operands and writes its result (``copy_``, ``fill_`` and
  ``zero_`` only write). Views (``view``, ``reshape`` of a contiguous
  tensor, ``transpose``, ``expand``, ``slice``, ``select``, ``detach``)
  cost nothing;
* ``bytes_min``: each leaf input (params, state, batch, cache) once, the
  outputs that do not alias an input, and the bytes the kernels report:
  the memory term's lower bound.

**Kernels.** The wrappers of ``kernels/ops.py`` credit their call to the
active counter with the function's own work (``Counter.kernel``): its
FLOPs and its least bytes, each operand once plus its output. The ops
inside (the plain version on the CPU or on meta, the glue around the
launch on the card) are not counted again, so one call counts the same
on every device.

**Collectives.** ``distributed/sharding.py``'s collectives and the pod
group's all-reduce report to the counter's census
(``launch/collectives.py``); their own copies, ``cat`` and ``sum`` are
not compute.

**Mesh positions and memory.** Every shard of a meta mesh lies on the
one ``meta`` device, so bytes cannot be kept per device by device.
``smap`` makes the position it runs the current one (``Counter.at``);
an op outside any position runs where its inputs lie (the first input
that one position holds; position 0, the controller's first device,
otherwise). Each storage is held by the positions that use it: where it
was made, each position ``smap`` hands a whole tensor to, each member of
a collective that receives it. Live bytes per position rise when a
storage appears and fall when it is freed (a weak reference on the
storage), and the peak is kept per position.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import collectives as CL

aten = torch.ops.aten

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost_counter", default=None)
_POSITION: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_position", default=None)

# ops that allocate, read metadata or alias without moving data
FREE = {aten._unsafe_view, aten.lift_fresh, aten.empty, aten.empty_like,
        aten.empty_strided, aten.new_empty, aten.new_empty_strided,
        aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
        aten.sym_numel, aten.sym_storage_offset, aten.alias,
        aten.is_same_size}
WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
              aten.min, aten.argmax, aten.argmin, aten.prod,
              aten.logsumexp, aten.cumsum, aten.cumprod, aten.var,
              aten.std, aten.var_mean, aten.linalg_vector_norm, aten.norm,
              aten.any, aten.all}
SOFTMAX = {aten._softmax, aten._log_softmax}
SORTS = {aten.sort, aten.topk, aten.kthvalue}
# pointwise ops the reference counts as free: comparisons and casts
FREE_POINTWISE = {aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge,
                  aten.logical_not, aten.logical_and, aten.logical_or,
                  aten.isnan, aten.isinf, aten.isfinite, aten._to_copy,
                  aten.clone, aten.copy_, aten.bitwise_not,
                  aten.bitwise_and, aten.bitwise_or}


def active() -> Optional["Counter"]:
    """The counter running in this context, or None."""
    return _ACTIVE.get()


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, acc=None):
    """The tensors of an op's arguments or results (lists, tuples, dicts;
    a quicker walk than ``tree_flatten``, which dominates a count)."""
    acc = [] if acc is None else acc
    if isinstance(tree, torch.Tensor):
        acc.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, acc)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, acc)
    return acc


def placed_tensors(tree):
    """(position, tensor) of every tensor of a tree of dicts, lists,
    tuples, tensors (at position 0, the controller's device) and
    ``Sharded`` values (each shard at its row-major position)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [pt for v in tree for pt in placed_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [(0, tree)]
    shards = getattr(tree, "shards", None)
    if isinstance(shards, np.ndarray):
        return [(int(np.ravel_multi_index(p, shards.shape)), shards[p])
                for p in np.ndindex(shards.shape)]
    return []


class _Stats:
    """What one mesh position ran: FLOPs, products by dtype, bytes."""

    def __init__(self):
        self.flops = 0
        self.dot_flops = 0
        self.dot_by_dtype: Dict[torch.dtype, int] = defaultdict(int)
        self.bytes = 0
        self.kernel_bytes = 0


class Counter(TorchDispatchMode):
    """Counts what runs under it (see the module docstring). Enter it as
    a context manager; ``costs()``, ``memory_at()``, ``bytes_min_at()``
    and ``census`` read the counts afterwards."""

    def __init__(self):
        super().__init__()
        self.pos: Dict[int, _Stats] = defaultdict(_Stats)
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.census = CL.Census()
        self.live: Dict[int, int] = defaultdict(int)
        self.peak: Dict[int, int] = defaultdict(int)
        self.args: Dict[int, int] = defaultdict(int)
        self.outs: Dict[int, int] = defaultdict(int)
        self.alias: Dict[int, int] = defaultdict(int)
        self._storages: Dict[int, list] = {}     # key -> [bytes, positions]
        self._arg_keys = set()
        self._quiet = 0
        self._token = None

    # -- context ------------------------------------------------------------

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.reset(self._token)

    @contextlib.contextmanager
    def at(self, pos: int, quiet: bool = False):
        """Run the block as mesh position ``pos`` (row-major index);
        ``quiet``: without counting its ops."""
        token = _POSITION.set(int(pos))
        self._quiet += quiet
        try:
            yield
        finally:
            self._quiet -= quiet
            _POSITION.reset(token)

    @contextlib.contextmanager
    def kernel(self, name: str, work):
        """A kernel wrapper's call: credited with ``work()`` = (FLOPs,
        least bytes, dtype of its products), its ops (and ``work``'s own)
        not counted."""
        self._quiet += 1
        try:
            flops, moved, dtype = work()
            s = self.pos[self._here()]
            s.flops += flops
            s.dot_flops += flops
            s.dot_by_dtype[dtype] += flops
            s.bytes += moved
            s.kernel_bytes += moved
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0,
                                               "dtype": str(dtype)})
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(moved)
            yield
        finally:
            self._quiet -= 1

    # -- memory -------------------------------------------------------------

    def _here(self, ts=()) -> int:
        pos = _POSITION.get()
        if pos is not None:
            return pos
        for t in ts:
            e = self._storages.get(_key(t))
            if e is not None and len(e[1]) == 1:
                return next(iter(e[1]))
        return 0

    def hold(self, t: torch.Tensor, pos: int):
        """Position ``pos`` holds ``t``'s storage (until it is freed)."""
        key = _key(t)
        if key is None:
            return
        e = self._storages.get(key)
        if e is None:
            st = t.untyped_storage()
            e = self._storages[key] = [st.nbytes(), set()]
            weakref.finalize(st, self._free, key)
        if pos not in e[1]:
            e[1].add(pos)
            self.live[pos] += e[0]
            if self.live[pos] > self.peak[pos]:
                self.peak[pos] = self.live[pos]

    def _free(self, key):
        e = self._storages.pop(key, None)
        if e is not None:
            for p in e[1]:
                self.live[p] -= e[0]

    def add_args(self, tree):
        """The program's inputs, live before it starts: held where they
        lie, each storage counted once toward ``bytes_min``."""
        for pos, t in placed_tensors(tree):
            key = _key(t)
            if key is None or (key, pos) in self._arg_keys:
                continue
            self._arg_keys.add((key, pos))
            self.hold(t, pos)
            self.args[pos] += t.untyped_storage().nbytes()

    def add_outputs(self, tree):
        """The program's outputs: those whose storage is an input's are
        aliases (updated in place)."""
        seen = set()
        for pos, t in placed_tensors(tree):
            key = _key(t)
            if key is None or (key, pos) in seen:
                continue
            seen.add((key, pos))
            self.outs[pos] += nbytes(t)
            if (key, pos) in self._arg_keys:
                self.alias[pos] += nbytes(t)

    # -- collectives ----------------------------------------------------------

    def collective(self, kind: str, axes, members):
        """One group of a collective: ``members`` = [(position, result
        tensor)]. Each member holds its result and receives its traffic;
        a result that requires grad records the backward's transpose when
        its gradient arrives."""
        op = CL.HLO_NAME[kind]
        n = len(members)
        for pos, r in members:
            self.hold(r, pos)
            self.census.record(op, axes, n, CL.traffic(op, nbytes(r), n), pos)
            if n > 1 and kind != "pmax" and r.requires_grad:
                r.register_hook(self._transpose(op, axes, n, pos))

    def _transpose(self, op, axes, n, pos):
        back = CL.TRANSPOSE[op]

        def hook(g):
            # the gradient is the transposed collective's operand
            b = 2 * nbytes(g) if back == "all-reduce" else nbytes(g)
            self.census.record(back, axes, n, b, pos)
        return hook

    # -- ops ------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        pos = self._here(ins)
        for t in outs:
            self.hold(t, pos)
        if self._quiet or func.is_view or packet in FREE or (
                packet is aten._to_copy and outs and
                outs[0].device != ins[0].device):
            return out      # a copy between devices is no op on either
        s = self.pos[pos]
        flops = 0
        dot = flop_registry.get(packet)
        if dot is not None:
            flops = int(dot(*args, **kwargs, out_val=out))
            s.dot_flops += flops
            s.dot_by_dtype[ins[0].dtype] += flops
        elif packet in REDUCTIONS:
            flops = ins[0].numel()
        elif packet in SOFTMAX:
            flops = 5 * ins[0].numel()
        elif packet in SORTS:
            flops = 10 * ins[0].numel()
        elif torch.Tag.pointwise in func.tags and \
                packet not in FREE_POINTWISE and outs:
            flops = outs[0].numel()
        read = ins[1:] if packet in WRITE_ONLY else ins
        moved = sum(nbytes(t) for t in read) + sum(nbytes(t) for t in outs)
        s.flops += flops
        s.bytes += moved
        rec = self.by_op[packet.__name__]
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        return out

    # -- results ---------------------------------------------------------------

    def positions(self):
        return sorted(set(self.pos) | set(self.peak) | set(self.args))

    def bytes_min_at(self, pos: int) -> int:
        return self.args[pos] + self.outs[pos] - self.alias[pos] + \
            self.pos[pos].kernel_bytes

    def costs(self) -> Dict[str, Any]:
        """Global counts, summed over positions (the reference's
        ``fn_costs`` keys and more)."""
        ps = self.positions()
        dot_by = defaultdict(int)
        for p in ps:
            for dt, f in self.pos[p].dot_by_dtype.items():
                dot_by[str(dt).replace("torch.", "")] += f
        return {
            "flops": sum(self.pos[p].flops for p in ps),
            "dot_flops": sum(self.pos[p].dot_flops for p in ps),
            "dot_flops_by_dtype": dict(dot_by),
            "bytes": sum(self.pos[p].bytes for p in ps),
            "bytes_min": sum(self.bytes_min_at(p) for p in ps),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "by_op": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                      for k, v in sorted(self.by_op.items())},
            # the reference's key: its jaxpr walk warns of a while loop
            # counted once; every op of an eager run is counted as it runs
            "warnings": [],
        }

    def memory_at(self, pos: int) -> Dict[str, int]:
        """Bytes at one position: args, outputs, aliases, peak live."""
        return {"args": self.args[pos], "out": self.outs[pos],
                "alias": self.alias[pos], "peak": self.peak[pos]}


def _key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):     # no storage
        return None


def fn_costs(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` under a ``Counter`` and return its global counts:
    ``{"flops", "dot_flops", "bytes", "bytes_min", "kernels", "by_op",
    "warnings"}`` (and ``dot_flops_by_dtype``)."""
    with Counter() as c:
        c.add_args(args)
        out = fn(*args)
        c.add_outputs(out)
    return c.costs()
