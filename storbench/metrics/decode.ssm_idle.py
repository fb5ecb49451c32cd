"""Share of the traced window in which no operation ran on the card while
the decode worker was inside one of the program's ``decode.mixer`` spans
of kind ``ssm`` (the trace's idle gaps intersected with those spans,
``program_spans`` through ``mixers``), in %: the card starving while the
host dispatches the Mamba-2 layers. A note gives the same for the
``moe`` and ``attn`` mixers."""
import mixers


def read(ctx):
    share = {k: mixers.idle_share(ctx, k) for k in mixers.KINDS}
    if share["ssm"] is not None:
        ctx.notes.append("device idle inside decode mixers: " + ", ".join(
            f"{k} {v:.3f}%" for k, v in share.items() if v is not None))
    return share["ssm"]
