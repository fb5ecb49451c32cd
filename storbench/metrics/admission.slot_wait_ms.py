"""Mean time a searched miss waited for a decode slot: the program's
``decode.queue`` spans (from the search worker's routing to the start of
the request's prefill in ``BatchScheduler._admit``: the decode queue,
then ``waiting`` while a wave decodes), over those that ended inside the
window."""
import program_spans as PS


def read(ctx):
    s = PS.in_window(ctx, "decode.queue")
    return PS.mean_ms(x.wall_s for x in s) if s else None
