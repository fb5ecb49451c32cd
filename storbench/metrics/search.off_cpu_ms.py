"""Mean off-CPU time of one embed + search microbatch: wall less the
search worker's thread CPU time over each of the program's
``search.batch`` spans that ended inside the window. A thread is off the
CPU while it waits for the interpreter lock (here mostly behind the
decode worker, whose every torch op drops and retakes it) or sleeps in a
blocking wait; a CUDA synchronise on a host with more cores than cards
spins, and spinning counts as CPU time, so this is the lock's share."""
import program_spans as PS


def read(ctx):
    s = PS.in_window(ctx, "search.batch")
    return PS.mean_ms(x.off_cpu_s for x in s) if s else None
