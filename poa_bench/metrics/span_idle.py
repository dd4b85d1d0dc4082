"""The share of the traced window, percent, in which the host is inside
one of the program's spans named in spec 'spans' and no kernel, copy or
memset runs on the device. The spans' host times are moved onto the
trace's clock by `progtrace.trace_offset_us`."""

from .. import devtrace, progtrace


def read(spec, data):
    if data.trace is None:
        return None
    found = [e for _req, events in progtrace.by_request(data)
             for e in progtrace.spans(events, spec["spans"])]
    if not found:
        return None
    off = progtrace.trace_offset_us(data)
    if off is None:
        return None
    lo, hi = data.trace.window
    host = devtrace.union([{"ts": e["t0"] / 1e3 + off, "dur": (e["t1"] - e["t0"]) / 1e3}
                           for e in found])
    host = [(max(a, lo), min(b, hi)) for a, b in host if min(b, hi) > max(a, lo)]
    device = devtrace.union(devtrace.clip(data.trace.device, lo, hi))
    idle = sum(b - a for a, b in host) - progtrace.overlap_us(host, device)
    return 100.0 * idle / (hi - lo)
