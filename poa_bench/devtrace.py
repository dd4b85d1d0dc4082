"""Requests under torch.profiler, and what the benchmark reads from the trace.

A traced block runs a fixed number of whole requests inside one
`record_function` range (the traced window). Each request's phases are
ranges too: the program reports the end of each prove phase through its
`log=` callback after a device synchronize, and the callback closes the
current range and opens the next, so a phase's kernels lie inside its
range. The chrome trace goes to a temporary file and is read back as
device events (kernels, copies, memsets) and phase ranges, all on the
profiler's clock in microseconds.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "poa_bench.window"
_RANGE = re.compile(r"^poa_bench\.r(-?\d+)\.p(\d+)$")
_SECONDS = re.compile(r" \d+(\.\d+)?s$")


def phase_name(msg: str) -> str:
    """'prove: witness upload 0.563s' -> 'witness upload'."""
    return _SECONDS.sub("", msg.split(": ", 1)[-1])


@dataclass
class Trace:
    window: Tuple[float, float]  # us
    device: List[dict]  # chrome-trace events with ts, dur (us), name, cat
    phases: List[Tuple[int, str, float, float]]  # (request, phase name, start us, end us)


def busy_us(events) -> float:
    """Length of the union of device intervals (chrome-trace events with ts
    and dur in microseconds). Frozen copy of `chip_smoke.py` `busy_us`."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def union(events) -> List[Tuple[float, float]]:
    """The device intervals merged: disjoint (start, end) in order."""
    out: List[List[float]] = []
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return [(a, b) for a, b in out]


def clip(events, lo: float, hi: float) -> List[dict]:
    """Device events cut to [lo, hi]."""
    out = []
    for e in events:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            out.append(dict(e, ts=a, dur=b - a))
    return out


def parse(trace: dict, phase_names: Dict[int, List[str]]) -> Trace:
    window, device, phases = None, [], []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append(e)
        elif e.get("cat") == "user_annotation":
            if e["name"] == WINDOW:
                window = (e["ts"], e["ts"] + e["dur"])
                continue
            m = _RANGE.match(e["name"])
            if m:
                i, k = int(m.group(1)), int(m.group(2))
                names = phase_names.get(i, [])
                name = names[k] if k < len(names) else "return"
                phases.append((i, name, e["ts"], e["ts"] + e["dur"]))
    if window is None:
        raise RuntimeError("the trace holds no traced window")
    return Trace(window=window, device=device, phases=sorted(phases, key=lambda p: p[2]))


def traced(ctx, serve: Callable, ids) -> Tuple[list, Trace]:
    """Serve requests `ids` under the profiler; (requests, trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    requests, names = [], {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in ids:
                marks: List[Tuple[str, float]] = []
                ranges = [record_function(f"poa_bench.r{i}.p0")]
                ranges[0].__enter__()

                def log(msg, marks=marks, ranges=ranges, i=i):
                    marks.append((phase_name(msg), time.perf_counter()))
                    ranges[-1].__exit__(None, None, None)
                    ranges.append(record_function(f"poa_bench.r{i}.p{len(marks)}"))
                    ranges[-1].__enter__()

                try:
                    req = serve(ctx, i, log)
                finally:
                    ranges[-1].__exit__(None, None, None)
                req.phases = marks
                names[i] = [m[0] for m in marks]
                requests.append(req)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return requests, parse(trace, names)


def kernel_name(e: dict) -> str:
    return e["name"].split("(")[0].replace("void ", "")


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled with the phase the host was in (as measured, seconds)."""
    lo, hi = tr.window
    dev = clip(tr.device, lo, hi)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[kernel_name(e)] = by_name.get(kernel_name(e), 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [lo] + [t for iv in union(dev) for t in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            label = next((f"r{i}: {name}" for i, name, s, e in tr.phases if s <= mid <= e),
                         "between requests")
            gaps.append((label, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}
