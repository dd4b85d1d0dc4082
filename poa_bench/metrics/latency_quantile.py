"""A quantile (spec 'q') of every completed request's latency, seconds;
only where the window holds at least spec 'min_requests' of them."""

import statistics


def read(spec, data):
    lat = [r.t_end - r.t_start for r in data.requests if r.proof is not None]
    if len(lat) < max(spec.get("min_requests", 2), 2):
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[round(spec["q"] * 100) - 1]
