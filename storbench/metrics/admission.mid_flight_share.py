"""Share of admissions that joined a batch mid-decode, in %: the
program's ``admission.prefill`` spans that ended inside the window with
``mid_flight`` true (a slot that decoded in the chunk before was still
live at that admission), over those that carry the attribute. Wave
admission reads 0; a program whose spans lack the attribute gives no
value."""
import program_spans as PS


def read(ctx):
    s = [x for x in PS.in_window(ctx, "admission.prefill") or ()
         if x.attrs and "mid_flight" in x.attrs]
    if not s:
        return None
    return 100.0 * sum(bool(x.attrs["mid_flight"]) for x in s) / len(s)
