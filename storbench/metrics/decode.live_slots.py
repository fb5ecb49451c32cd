"""Mean number of slots decoding in a decode step over the window: what
wave-gated admission lets the batch hold."""


def read(ctx):
    ch = ctx.decode_chunks()
    steps = sum(c.steps * f for c, f in ch)
    return sum(c.live * c.steps * f for c, f in ch) / steps if steps \
        else None
