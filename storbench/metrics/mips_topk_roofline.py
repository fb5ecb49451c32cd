"""B1 (the flat fp16 store's MIPS top-k
scan): its least time per call from the call's shapes
(``roofline.py``) over its device time per launch in the trace, in %."""


def read(ctx):
    return ctx.roofline("mips_topk")
