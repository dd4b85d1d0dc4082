"""Requests completed over the time they took: from the first request's
start to the last one's end, so a stall anywhere in the window counts."""


def read(spec, data):
    done = [r for r in data.requests if r.proof is not None]
    if not done:
        return None
    span = max(r.t_end for r in done) - min(r.t_start for r in data.requests)
    return len(done) / span
