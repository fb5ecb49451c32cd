"""Output tokens the decode stage produced inside the window, per second
of it: every scheduler step's tokens (the first token of each admitted
request and each decode chunk's), counted by the share of the step's
span that lies inside the window, over the window's length."""


def read(ctx):
    w = ctx.win.t1 - ctx.win.t0
    return sum(c.tokens * ctx.share_in_window(c.t0, c.t1)
               for c in ctx.rec.chunks) / w
