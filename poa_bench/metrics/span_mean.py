"""Mean over the traced requests of the host time inside the program's
spans named in spec 'spans' (`zkpoa_tpu_torch/utils/trace.py`, in ns),
times spec 'scale'."""

from .. import progtrace


def read(spec, data):
    per_req = [progtrace.spans(events, spec["spans"]) for _req, events in
               progtrace.by_request(data)]
    if not any(per_req):
        return None
    total = sum(e["t1"] - e["t0"] for found in per_req for e in found)
    return total / len(per_req) * spec.get("scale", 1.0)
