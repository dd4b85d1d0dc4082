"""A roofline share, percent: the least time the card could take for the
work that `work/<spec 'work'>.py` reckons for the traced requests, over
the device time of the kernels that do it. The kernels are those whose
names contain one of spec 'kernels' (all kernels where it is absent),
inside the phases whose names start with one of spec 'phases' (anywhere
in a request where it is absent)."""

import importlib

from .. import devtrace
from ..peaks import bound_s


def read(spec, data):
    if data.trace is None or data.peaks is None:
        return None
    phases = [(s, e) for _, name, s, e in data.trace.phases
              if "phases" not in spec or any(name.startswith(p) for p in spec["phases"])]
    kernels = spec.get("kernels")
    device_us = 0.0
    for e in data.trace.device:
        if e["cat"] != "kernel" or (kernels and not any(k in e["name"] for k in kernels)):
            continue
        if any(s <= e["ts"] <= t for s, t in phases):
            device_us += e["dur"]
    if device_us <= 0:
        return None
    work = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.work.{spec['work']}")
    bound = sum(bound_s(*work.work(data.ctx, req), data.peaks) for req in data.requests
                if req.proof is not None)
    return 100.0 * bound / (device_us / 1e6)
