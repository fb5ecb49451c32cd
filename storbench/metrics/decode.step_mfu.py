"""The decode steps' share of the card's f32 peak (67 TFLOP/s on the CUDA
cores; the program keeps TF32 off), in %: the model FLOPs of the tokens
decoded inside the window (``flops.token_flops``: 2 per weight a token
multiplies through, plus attention over the positions it attends) over
the decode time that produced them."""
import flops
import roofline


def read(ctx):
    ch = ctx.decode_chunks()
    work = 0.0
    for c, f in ch:
        for n in c.decoded:
            work += f * sum(flops.token_flops(ctx.cfg, c.cache_len + 2 + j)
                            for j in range(n))
    busy = sum((c.t1 - c.t0 - c.admit_s) * f for c, f in ch)
    return 100.0 * work / (busy * roofline.F32_FLOPS) if busy else None
