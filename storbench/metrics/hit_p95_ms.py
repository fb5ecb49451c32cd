"""95th percentile of the client-side latency of the hits answered inside
the window (submit to resolved future)."""
import numpy as np


def read(ctx):
    lat = [td - ts for r, ts, td, res in ctx.answered() if res.hit]
    ctx.notes.append(f"hit_p95_ms over {len(lat)} hits")
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
