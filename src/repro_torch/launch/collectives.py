"""Census of the port's collectives: the counterpart of the JAX package's
``launch/hlo_collectives.py``. The port has no HLO to parse: its
collectives are the one-controller tensor ops of
``distributed/sharding.py`` (``all_gather``, ``psum``, ``pmax``,
``pmean``, ``psum_replicas``, ``all_to_all``) and the pod group's
``dist.all_reduce`` of ``distributed/multihost.py`` (``pod_sum``,
``all_reduce_grads``), and each reports itself to the active cost
counter (``launch/costs.py``) as it runs, with its axes, its group size
and the bytes one member receives.

Per-op traffic model (bytes crossing one device's links), the
reference's:

  all-gather          result bytes
  all-to-all          result bytes
  collective-permute  result bytes
  reduce-scatter      operand bytes (result x group size)
  all-reduce          2 x result bytes (ring reduce-scatter + all-gather)

A group of one member moves nothing and is not recorded.

**The backward.** On one controller the backward of a collective is
plain autograd of its copies, ``cat`` and ``sum``, which moves the same
data back. Where a collective's input requires grad, a hook on each
member's result records the transpose when its gradient arrives:
all-gather -> reduce-scatter of the same bytes, psum and pmean ->
all-reduce, all-to-all -> all-to-all. A recomputation (remat) that runs a
collective again records its forward again, and its transpose only if
its backward runs. ``pmax`` has no transpose (the port's max is
detached, as the reference's is).

Not in the census: the controller's placement copies (``shard``,
``Sharded.full``, ``smap``'s copy of a whole tensor to each position),
which the reference's jit expresses as input and output shardings.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

# the sharding module's collectives, by their HLO names
HLO_NAME = {"all_gather": "all-gather", "psum": "all-reduce",
            "pmean": "all-reduce", "pmax": "all-reduce",
            "all_to_all": "all-to-all"}
# the collective that a collective's backward runs
TRANSPOSE = {"all-gather": "reduce-scatter", "all-reduce": "all-reduce",
             "all-to-all": "all-to-all"}


def traffic(op: str, result_bytes: int, group: int) -> int:
    """Bytes one member of a ``group``-member ``op`` receives, from the
    bytes of its result (the reference's model)."""
    if op == "all-reduce":
        return 2 * result_bytes
    if op == "reduce-scatter":
        return result_bytes * group
    return result_bytes


def axis_key(axes) -> str:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return ",".join(axes)


class Census:
    """The collectives one run issued, per mesh position (row-major index):
    op, axes, group size, bytes received."""

    def __init__(self):
        # (position, op, axes key, group) -> [count, bytes]
        self.records: Dict[tuple, list] = defaultdict(lambda: [0, 0])

    def record(self, op: str, axes, group: int, nbytes: int, pos: int = 0):
        if group <= 1:
            return
        r = self.records[(pos, op, axis_key(axes), group)]
        r[0] += 1
        r[1] += int(nbytes)

    def positions(self):
        return sorted({k[0] for k in self.records})

    def at(self, pos: int) -> Dict[str, object]:
        """``{"counts", "bytes", "total_bytes", "by_axis"}`` of one
        position (``hlo_collectives.collective_bytes``'s keys, per
        device)."""
        counts, nbytes, by_axis = (defaultdict(int) for _ in range(3))
        for (p, op, axes, _), (n, b) in self.records.items():
            if p != pos:
                continue
            counts[op] += n
            nbytes[op] += b
            by_axis[axes] += b
        return {"counts": dict(counts), "bytes": dict(nbytes),
                "total_bytes": float(sum(nbytes.values())),
                "by_axis": dict(by_axis)}

    def seconds_at(self, pos: int, rate_of) -> float:
        """The time one position's traffic takes with each group charged at
        ``rate_of(axes key)`` bytes/s."""
        return sum(b / rate_of(axes) for (p, _, axes, _), (_, b)
                   in self.records.items() if p == pos)

    def busiest(self, rate_of) -> int:
        """The position whose traffic takes longest at ``rate_of`` (see
        ``seconds_at``); 0 when nothing was recorded."""
        return max(self.positions(), default=0,
                   key=lambda p: self.seconds_at(p, rate_of))
