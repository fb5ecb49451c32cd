"""Mean time a request sat in the admit queue before the search stage
took it: the pipeline's own cumulative ``stages["search"]`` wait and
item counters, differenced at the window's edges."""


def read(ctx):
    n0, w0 = ctx.win.stage0["search"]
    n1, w1 = ctx.win.stage1["search"]
    return 1e3 * (w1 - w0) / (n1 - n0) if n1 > n0 else None
