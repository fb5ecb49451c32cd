"""Mean host time of one embed + search microbatch
(``BatchedRuntime._search_batch``: MiniLM on B4, the flat scan on B1,
and the copies back), over the spans that ended inside the window."""


def read(ctx):
    d = [s.t1 - s.t0 for s in ctx.rec.searches
         if ctx.win.t0 <= s.t1 <= ctx.win.t1]
    return 1e3 * sum(d) / len(d) if d else None
