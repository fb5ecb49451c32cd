"""The embed + search stage's share of the card's f32 peak (67 TFLOP/s;
the program keeps TF32 off), in %: the model FLOPs of the window's search
microbatches (for each query, MiniLM over its 64 positions: 2 per weight
and 2 (q.k + p.v) per attended pair, and the exact scan of the store,
2 N D) over the time of their spans. The whole stage's share beside
B1's roofline: a kernel taken off the path leaves its roofline silent,
not this."""
import roofline

POSITIONS = 64


def query_flops(enc: dict, rows: int) -> float:
    d, ff, layers = enc["dim"], enc["d_ff"], enc["layers"]
    per_position = layers * (2 * (4 * d * d + 2 * d * ff)
                             + 2 * 2 * POSITIONS * d)
    return POSITIONS * per_position + 2.0 * rows * d


def read(ctx):
    sysc = ctx.cfg["system"]
    per_query = query_flops(sysc["minilm"], sysc["store_rows"])
    spans = [s for s in ctx.rec.searches
             if ctx.win.t0 <= s.t1 <= ctx.win.t1]
    busy = sum(s.t1 - s.t0 for s in spans)
    work = per_query * sum(len(s.texts) for s in spans)
    return 100.0 * work / (busy * roofline.F32_FLOPS) if busy else None
