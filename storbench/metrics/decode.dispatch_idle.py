"""Share of the traced window in which no operation ran on the card while
the decode worker was inside one of the program's ``decode.step`` spans
(the trace's idle gaps intersected with those spans), in %: the card
starving while the host dispatches a step. A note splits all of the
card's idle time by what the program's spans say the host was doing."""
import program_spans as PS


def read(ctx):
    s = PS.in_window(ctx, "decode.step")
    if not s:
        return None
    t = ctx.win.trace
    idle = PS.length(PS.intersect(PS.gaps(ctx),
                                  PS.merged((x.t0, x.t1) for x in s)))
    split = PS.idle_split(ctx)
    if split and t.window_s:
        ctx.notes.append("device idle by host span: " + ", ".join(
            f"{'rest of ' * (n == 'decode.chunk')}{n} "
            f"{100.0 * v / t.window_s:.3f}%" for n, v in split.items()))
    return 100.0 * idle / t.window_s if t.window_s else None
