"""B3 (GQA decode attention over the bf16
cache): its least time per call from the call's shapes
(``roofline.py``) over its device time per launch in the trace, in %."""


def read(ctx):
    return ctx.roofline("decode_attention")
