"""Host time of one decode step: each scheduler step's span less its
admission (prefills end in a host read of the first token, a decode
chunk in the host copy of its tokens, so both are synchronised), summed
over the window and divided by the decode steps run."""


def read(ctx):
    ch = ctx.decode_chunks()
    steps = sum(c.steps * f for c, f in ch)
    busy = sum((c.t1 - c.t0 - c.admit_s) * f for c, f in ch)
    return 1e3 * busy / steps if steps else None
