"""Share of the traced part of the window in which no operation ran on the
card, in %."""


def read(ctx):
    t = ctx.win.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s \
        else None
