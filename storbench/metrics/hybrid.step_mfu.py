"""The decode steps' share of the card's f32 peak, in %, read by
``decode.step_mfu``'s own reader (the configuration's ``token_flops``
over the decode time that produced the window's tokens), for the cells
that metric does not list."""
import cell


def read(ctx):
    return cell.load_module(cell.HERE / "metrics" / "decode.step_mfu.py") \
        .read(ctx)
