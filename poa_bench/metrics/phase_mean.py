"""Mean over the traced requests of the time spent in the phases whose
names start with one of spec 'phases' (the program's own phase ends on the
host clock, after its synchronize), times spec 'scale'."""


def read(spec, data):
    per_req = []
    for req in data.requests:
        t_prev, total, seen = req.t_start, 0.0, False
        for name, t in req.phases:
            if any(name.startswith(p) for p in spec["phases"]):
                total += t - t_prev
                seen = True
            t_prev = t
        if seen:
            per_req.append(total)
    if not per_req:
        return None
    return sum(per_req) / len(per_req) * spec.get("scale", 1.0)
