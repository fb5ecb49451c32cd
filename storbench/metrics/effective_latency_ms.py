"""The paper's effective latency (§4), measured: the mean, over every
request answered inside the window (hits and misses alike), of the time
from ``submit()`` to its resolved future on the client side."""


def read(ctx):
    lat = [td - ts for _, ts, td, _ in ctx.answered()]
    ctx.notes.append(f"effective_latency_ms over {len(lat)} answered "
                     f"requests")
    return 1e3 * sum(lat) / len(lat) if lat else None
