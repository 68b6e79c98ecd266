"""The 95th percentile of every request's latency in the traced window,
from the client's call to the result in hand (the host's clock)."""

import statistics


def read(rec):
    lat = rec.get("latencies_ms") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20)[18], "ms"
