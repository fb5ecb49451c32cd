"""The useful share of the rows the decode step computes, in %: tokens
kept (the program's per-slot count in each ``decode.chunk`` span) over
slots x steps of those chunks (every step computes all B slots, and a
chunk runs past a request's ``max_new`` or EOS), over the chunks that
ended inside the window."""
import program_spans as PS


def read(ctx):
    s = PS.in_window(ctx, "decode.chunk")
    rows = sum(x.attrs["slots"] * x.attrs["steps"] for x in s or ())
    if not rows:
        return None
    return 100.0 * sum(sum(x.attrs["tokens"].values()) for x in s) / rows
