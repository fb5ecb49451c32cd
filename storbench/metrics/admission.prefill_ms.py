"""Mean time of one admission: the program's ``admission.prefill`` spans
(the B=1 prefill, the slot write and the host read of the first token,
in ``BatchScheduler._admit``), over those that ended inside the window."""
import program_spans as PS


def read(ctx):
    s = PS.in_window(ctx, "admission.prefill")
    return PS.mean_ms(x.wall_s for x in s) if s else None
