"""The port's span recorder: named intervals of the serving path on the
host's ``time.perf_counter()`` clock, kept in memory for whoever reads
them (a benchmark, an operator, a test).

It records while any ``torch.profiler`` session runs (PyTorch's own fast
flag, ``torch.autograd.profiler._is_profiler_enabled``) and between
``enable()`` and ``disable()``. Otherwise a span site costs one flag
check: ``start()`` returns None, with no clock read, no allocation and
no lock.

A site::

    t = trace.start()
    ...the work...
    if t is not None:
        trace.end(t, "decode.step", cache_len=n)

A span carries its thread's CPU time (``time.thread_time()`` at both
ends), so wall less CPU is the time the thread did not run: waiting on
the interpreter lock, mostly, since a CUDA synchronise on a host with
more cores than cards spins and counts as CPU. A span that starts on one
thread and ends on another (``add``) has no CPU time.

Spans of one request share its ``rid`` (a batch span lists ``rids``).
Up to ``LIMIT`` spans are kept; past that they are dropped and counted
(``dropped()``). ``clock_offset_ns()`` is ``time.time_ns() -
time.perf_counter_ns()`` taken when recording began, to lay the spans
over an exported profile, whose events are stamped on the wall clock.

The spans the serving path records (each where the work happens):

=====================  ====================================  ===========
name                   where                                 attributes
=====================  ====================================  ===========
``search.batch``       ``ServingPipeline._search_worker``:   ``rids``,
                       one microbatch's embed + search       ``n``
``decode.queue``       a miss from its routing to the        ``rid``
                       decode worker (or ``submit``) to the
                       start of its prefill
``admission.prefill``  ``BatchScheduler._admit``: prefill,   ``rid``,
                       slot write and first-token read       ``prompt_len``
``decode.chunk``       ``BatchScheduler.step_chunk`` after   ``slots``,
                       admission, to the last retire         ``steps``,
                                                             ``tokens``
                                                             ({rid: kept})
``decode.step``        ``Engine._decode_chunk``: one step,   ``cache_len``
                       its sampling and its ``where``
=====================  ====================================  ===========
"""
from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler

LIMIT = 1 << 20


class Span(NamedTuple):
    name: str
    t0: float                   # perf_counter seconds
    t1: float
    cpu_s: Optional[float]      # the thread's CPU seconds over the span
    thread: str
    rid: Optional[int] = None
    rids: Optional[Tuple[int, ...]] = None
    attrs: Optional[dict] = None

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    @property
    def off_cpu_s(self) -> Optional[float]:
        """Wall time in which the span's thread did not run."""
        return None if self.cpu_s is None else self.t1 - self.t0 - self.cpu_s


class Recorder:
    """A bounded, lock-free span buffer (``list.append`` is atomic under
    the interpreter lock; a drop past the bound takes a lock)."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.enabled = False
        self._spans: List[Span] = []
        self._dropped = 0
        self._drop_lock = threading.Lock()
        self._offset_ns: Optional[int] = None

    def start(self):
        """(perf_counter, thread_time) while recording, else None."""
        if _profiler._is_profiler_enabled or self.enabled:
            return time.perf_counter(), time.thread_time()
        return None

    def now(self) -> Optional[float]:
        """perf_counter while recording, else None: a stamp for a span
        that another thread ends (``add``)."""
        if _profiler._is_profiler_enabled or self.enabled:
            return time.perf_counter()
        return None

    def end(self, start, name: str, rid: Optional[int] = None,
            rids=None, **attrs):
        """Close a span opened by ``start()`` on this thread."""
        t1, c1 = time.perf_counter(), time.thread_time()
        self._keep(Span(name, start[0], t1, c1 - start[1],
                        threading.current_thread().name, rid,
                        None if rids is None else tuple(rids),
                        attrs or None))

    def add(self, name: str, t0: float, t1: float, rid: Optional[int] = None,
            **attrs):
        """A span whose ends were stamped elsewhere (no CPU time)."""
        self._keep(Span(name, t0, t1, None, threading.current_thread().name,
                        rid, None, attrs or None))

    def _keep(self, span: Span):
        if self._offset_ns is None:
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
        if len(self._spans) < self.limit:
            self._spans.append(span)
        else:
            with self._drop_lock:
                self._dropped += 1

    def enable(self):
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.enabled = True

    def disable(self):
        self.enabled = False

    def spans(self) -> List[Span]:
        return list(self._spans)

    def dropped(self) -> int:
        return self._dropped

    def clock_offset_ns(self) -> Optional[int]:
        return self._offset_ns

    def clear(self):
        self._spans = []
        with self._drop_lock:
            self._dropped = 0
        self._offset_ns = None


# the process's one recorder, which the serving path writes to
RECORDER = Recorder()
start = RECORDER.start
now = RECORDER.now
end = RECORDER.end
add = RECORDER.add
enable = RECORDER.enable
disable = RECORDER.disable
spans = RECORDER.spans
dropped = RECORDER.dropped
clock_offset_ns = RECORDER.clock_offset_ns
clear = RECORDER.clear
