"""serve_p90_s: the 90th percentile of the client's latency, submit to
response, over every request of the window (nearest rank); a request that
failed counts as beyond any latency."""
import math


def read(run):
    if not run.units:
        return None
    lat = sorted(u.t1 - u.t0 if u.ok else math.inf for u in run.units)
    v = lat[max(math.ceil(0.9 * len(lat)) - 1, 0)]
    return v if math.isfinite(v) else None
