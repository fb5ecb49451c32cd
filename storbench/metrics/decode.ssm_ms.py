"""Host time of a decode step's Mamba-2 layers: the wall time of the
program's ``decode.mixer`` spans of kind ``ssm`` (``program_spans``,
through ``mixers``) inside each ``decode.step`` span that ended in the
window, summed per step, averaged over the steps, in ms."""
import mixers


def read(ctx):
    return mixers.step_ms(ctx, "ssm")
