"""The program's ``decode.mixer`` spans (``repro_torch.trace``): one a
layer a decode step of a layer-pattern stack, with the layer's mixer as
``kind`` (``ssm``, ``moe``, ``attn``), read through ``program_spans``. A
stack without them (any other model, or a program without the span)
gives no value."""
from __future__ import annotations

from typing import Optional

import program_spans as PS

KINDS = ("ssm", "moe", "attn")


def of_kind(ctx, kind: str) -> Optional[list]:
    """The window's ``decode.mixer`` spans of ``kind``; None where there
    are none."""
    s = PS.in_window(ctx, "decode.mixer")
    s = [x for x in s or () if (x.attrs or {}).get("kind") == kind]
    return s or None


def step_ms(ctx, kind: str) -> Optional[float]:
    """Mean over the window's ``decode.step`` spans of the wall time of
    the ``kind`` mixer spans inside each, in ms."""
    mix, steps = of_kind(ctx, kind), PS.in_window(ctx, "decode.step")
    if not mix or not steps:
        return None
    mix.sort(key=lambda x: x.t0)
    total, i = [], 0
    for st in sorted(steps, key=lambda x: x.t0):
        while i < len(mix) and mix[i].t0 < st.t0:
            i += 1
        t = 0.0
        while i < len(mix) and mix[i].t1 <= st.t1:
            t += mix[i].wall_s
            i += 1
        total.append(t)
    return PS.mean_ms(total)


def idle_share(ctx, kind: str) -> Optional[float]:
    """The card's idle time inside the ``kind`` mixer spans, as a share
    of the traced window, in %."""
    mix = of_kind(ctx, kind)
    t = ctx.win.trace
    if not mix or not t.window_s:
        return None
    idle = PS.intersect(PS.gaps(ctx), PS.merged((x.t0, x.t1) for x in mix))
    return 100.0 * PS.length(idle) / t.window_s
