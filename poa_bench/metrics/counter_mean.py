"""Mean over the traced requests of the program's counter spec 'counter'
(`zkpoa_tpu_torch/utils/trace.py` counts) summed over its sites, less
those in spec 'except_sites', times spec 'scale'."""

from .. import progtrace


def read(spec, data):
    skip = set(spec.get("except_sites", []))
    per_req, seen = [], False
    for _req, events in progtrace.by_request(data):
        counts = [e for e in events if e["kind"] == "count" and e["name"] == spec["counter"]]
        seen = seen or bool(counts)
        per_req.append(sum(e["n"] for e in counts if e["site"] not in skip))
    if not seen:
        return None
    return sum(per_req) / len(per_req) * spec.get("scale", 1.0)
