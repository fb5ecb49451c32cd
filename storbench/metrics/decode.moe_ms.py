"""Host time of a decode step's MoE layers: the wall time of the
program's ``decode.mixer`` spans of kind ``moe`` (``program_spans``,
through ``mixers``) inside each ``decode.step`` span that ended in the
window, summed per step, averaged over the steps, in ms. A note gives
the share of routed assignments that landed on an expert this card
holds, from the program's ``moe.routed`` and ``moe.held`` counters
(kept while the trace ran, from set-up's end to the pipeline's stop)."""
import mixers


def read(ctx):
    ms = mixers.step_ms(ctx, "moe")
    if ms is not None:
        from repro_torch import trace
        n = getattr(trace, "counts", dict)()
        if n.get("moe.routed"):
            ctx.notes.append(
                f"moe: {100.0 * n['moe.held'] / n['moe.routed']:.3f}% of "
                f"{int(n['moe.routed'])} routed assignments on held experts")
    return ms
