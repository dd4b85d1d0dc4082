"""The share of the traced window in which no kernel, copy or memset ran
on the device, percent."""

from .. import devtrace


def read(spec, data):
    if data.trace is None:
        return None
    lo, hi = data.trace.window
    busy = devtrace.busy_us(devtrace.clip(data.trace.device, lo, hi))
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
