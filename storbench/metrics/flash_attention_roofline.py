"""B4 (flash attention: MiniLM's layers and each
prefill): its least time per call from the call's shapes
(``roofline.py``) over its device time per launch in the trace, in %."""


def read(ctx):
    return ctx.roofline("flash_attention")
