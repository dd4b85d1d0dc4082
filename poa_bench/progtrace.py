"""What the program records of its own proves, for the readers.

The program (`zkpoa_tpu_torch/utils/trace.py`) records spans and counts
while the profiler runs, which the traced block does. Every span and count
of one prove call carries the id of that call's root span; a request owns
the proves whose root span lies inside its [t_start, t_end] (the program's
clock is `time.perf_counter_ns`, the requests' `time.perf_counter`). A
program that records nothing gives no proves, and the readers return None.

The device trace keeps only the benchmark's own ranges, so a span's host
times reach the trace's clock through an offset: the end of each phase
range `poa_bench.r{i}.p{k}` less the host time of the phase mark that
closed it, the median of these, refused where their spread (the
distance between their first and third quartiles, as the benchmark reads
spreads) is over SPREAD_MAX_US.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

SPREAD_MAX_US = 200.0


def program_events() -> List[dict]:
    """The program's buffered events; none where it keeps no buffer."""
    try:
        from zkpoa_tpu_torch.utils import trace
    except ImportError:
        return []
    events = getattr(trace, "events", None)
    return events() if callable(events) else []


def by_request(data) -> List[Tuple[object, List[dict]]]:
    """(request, the events of its proves) for each completed request
    that holds at least one prove."""
    proves: Dict[int, List[dict]] = {}
    roots = {}
    for e in program_events():
        if e.get("prove") is None:
            continue
        proves.setdefault(e["prove"], []).append(e)
        if e["kind"] == "span" and e["id"] == e["prove"]:
            roots[e["prove"]] = e
    out = []
    for req in data.requests:
        if req.proof is None:
            continue
        lo, hi = req.t_start * 1e9, req.t_end * 1e9
        mine = [ev for p, root in roots.items() if lo <= root["t0"] and root["t1"] <= hi
                for ev in proves[p]]
        if mine:
            out.append((req, mine))
    return out


def spans(events: List[dict], names) -> List[dict]:
    return [e for e in events if e["kind"] == "span" and e["name"] in names]


def trace_offset_us(data) -> Optional[float]:
    """Trace-clock microseconds less host microseconds, or None where the
    differences of the phase marks and their ranges spread over
    SPREAD_MAX_US."""
    diffs = []
    for req in data.requests:
        ranges = [p for p in data.trace.phases if p[0] == req.i]  # sorted by start
        for (name, t), (_i, rname, _s, end) in zip(req.phases, ranges):
            if rname == name:
                diffs.append(end - t * 1e6)
    if len(diffs) < 2:
        return None
    q1, _q2, q3 = statistics.quantiles(diffs, n=4)
    if q3 - q1 > SPREAD_MAX_US:
        return None
    return statistics.median(diffs)


def overlap_us(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two lists of disjoint sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
