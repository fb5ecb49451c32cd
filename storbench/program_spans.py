"""The program's own spans (``repro_torch.trace``) as the metric readers
see them, and the interval arithmetic that lays them over the trace's
idle gaps.

The program records spans while a ``torch.profiler`` session runs, which
a ``--trace 1`` run starts in set-up (``spans.Tracer.start``), so they
cover the traced window. Both the spans and the gaps are on the host's
``perf_counter`` clock. A program without the recorder (an older
checkout) gives no spans, and every reader then gives no value.
"""
from __future__ import annotations

from typing import List, Optional


def in_window(ctx, name: str) -> Optional[list]:
    """The program's spans called ``name`` that ended inside the window;
    None where the run has no trace or the program no recorder."""
    if ctx.win.trace is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return [s for s in trace.spans()
            if s.name == name and ctx.win.t0 <= s.t1 <= ctx.win.t1]


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None


def merged(intervals) -> List[tuple]:
    """Sorted, non-overlapping union of (t0, t1) intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def intersect(xs, ys) -> List[tuple]:
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> List[tuple]:
    """Parts of merged ``xs`` outside merged ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(xs) -> float:
    return sum(b - a for a, b in xs)


def gaps(ctx) -> List[tuple]:
    """The window's idle gaps of the card, merged."""
    return merged(ctx.win.trace.gaps)


# what the host was doing in an idle gap, first match wins: the decode
# worker's step, the rest of its chunk, an admission's prefill, the
# search worker's batch (which runs beside the decode worker)
HOST = ("decode.step", "decode.chunk", "admission.prefill", "search.batch")


def idle_split(ctx) -> Optional[dict]:
    """Seconds of the card's idle time in the window by the first of
    ``HOST`` whose span (one that ended inside the window) was open
    (``none``: no span open); None without a trace or spans."""
    per = {n: in_window(ctx, n) for n in HOST}
    if None in per.values() or not any(per.values()):
        return None
    rest = gaps(ctx)
    out = {}
    for n in HOST:
        cover = intersect(rest, merged((s.t0, s.t1) for s in per[n]))
        out[n] = length(cover)
        rest = subtract(rest, cover)
    out["none"] = length(rest)
    return out
