"""Tracing / profiling / run-log subsystem of the port.

Port of `zkpoa_tpu/utils/trace.py`: the same stage banners, STATS lines,
per-stage logs and joblog; the optional per-stage trace is a
`torch.profiler` chrome trace (`<log_dir>/torch_trace/<stage>.json`, open
it in chrome://tracing or Perfetto) where the JAX version wrote an xprof
trace. A stage that leaves the card busy is synchronised before its wall
time is taken.

The reference instruments every stage through `execute` (banner + timestamp
+ GNU-time `STATS: time %E ; mem %KKb ; cpu %P` lines,
ref scripts/lib/cmd_executor.sh:6-19), writes per-stage logs under
`<build>/logs/*.log`, and GNU parallel `--joblog` TSVs
(ref scripts/full_workflow.sh:431,552). This module is the TPU-native
equivalent: a `Tracer` that owns a run's log directory and emits

  * stage banners + STATS lines (wall s, process CPU s, peak-RSS MB) to
    stdout and a per-stage log file;
  * a `joblog.tsv` with one row per completed stage (seq, start epoch,
    wall, cpu, peak-RSS, status, stage name) — same columns GNU parallel
    records, so the reference's log-scraping habits carry over;
  * optional profiler traces per stage via `profile=True`.

Host CPU/RSS come from `resource.getrusage`. Where the process uses the
card, the STATS line adds its peak device memory so far
(`torch.cuda.max_memory_allocated`, never reset here, so a caller's own
reading stands), as peak-rss is the host's peak so far; both are kept per
stage in `Tracer.peaks`. Device time shows up in
the profiler traces, not the STATS line.

Spans and counters. `span(name)` times a block of the program and
`count(name, n, site=)` counts work at the place it happens (bytes copied
to the device, host waits on the card). Both record only while the torch
profiler runs or inside a `collect()` block; otherwise a call is one flag
check. A span records its name, host start and end
(`time.perf_counter_ns`, the clock of `time.perf_counter`), its parent
span and the id of the root span it lies in (`span(..., root=True)`; the
prover opens one per `_prove_device` call, so every span and count of one
prove shares that id). While the profiler runs, a span is also a
`record_function` range of its name, so its start and end sit on the
device trace's clock too. Events go to a bounded buffer that `events()`
returns; `collect()` also hands the block's own events to its caller. A
`Stage` is a span of its own name. The prover's counters: `h2d_bytes`,
the bytes of each host array a prove copies to its device;
`host_sync`, each place where the host waits on the card (a device value
read on the host, a call whose output size depends on device data, a
blocking copy, a synchronize); `host_mul`, each scalar multiplication
of a point in Python on the host (`heavy_g1` / `heavy_g2`: a heavy value
other than 1 in `ops/msm.py` `msm_many`, whose host combination is the
span `prove.msm.host`; `assembly_g1` / `assembly_g2`: the proof's
assembly); and `spmv_operands`, each SpMV evaluation (`ops/qap_eval.py`),
at site `fill` where it copied a system's operands to its device (those
copies are the `h2d_bytes` and `host_sync` of site `spmv_operands`) and
`hit` where it found them there, all by site.

Who reads them. The benchmark (`poa_bench/`) reads the upload's
conversion spans, `prove.msm.host` and the first three counters in its
traced run (`spmv_operands` is read by the tests alone). An operator reads
the ranges: `python -m zkpoa_tpu_torch.pipeline.workflow ... --profile`
writes one chrome trace a stage, and there each prove's phases
(`prove.upload` ... `prove.assembly`), the upload's parts and the
ceremony's `_timed` steps (`prover/ptau.py`) name what the host was doing
in each gap where the card idles. Site `prove.phase` of `host_sync`
counts the synchronizes a caller's `log` adds (seven a prove), which a
prove without `log` does not make.
"""

from __future__ import annotations

import itertools
import os
import resource
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled  # whether torch.profiler records
EVENTS_MAX = 1 << 16  # events the buffer keeps, the newest
_events: deque = deque(maxlen=EVENTS_MAX)
_sinks: List[list] = []  # the event lists of the open collect() blocks
_open: list = []  # the open spans, innermost last
_ids = itertools.count(1)
_OFF = nullcontext()


def _emit(event: dict) -> None:
    _events.append(event)
    for sink in _sinks:
        sink.append(event)


class _Span:
    __slots__ = ("name", "root", "id", "parent", "prove", "t0", "_range")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.prove = self.id if self.root else (outer.prove if outer else None)
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        _open.remove(self)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _emit({"kind": "span", "name": self.name, "id": self.id, "parent": self.parent,
               "prove": self.prove, "t0": self.t0, "t1": t1})
        return False


def span(name: str, root: bool = False):
    """Context manager timing the block as span `name`; a root span starts
    a new prove id for everything inside it. A no-op unless recording."""
    if not (_sinks or _profiling()):
        return _OFF
    return _Span(name, root)


def count(name: str, n: int = 1, site: Optional[str] = None) -> None:
    """Adds n to counter `name` at `site`, inside the innermost open span.
    A no-op unless recording."""
    if not (_sinks or _profiling()):
        return
    outer = _open[-1] if _open else None
    _emit({"kind": "count", "name": name, "site": site, "n": n, "t": time.perf_counter_ns(),
           "span": outer.id if outer else None, "prove": outer.prove if outer else None})


def events() -> List[dict]:
    """The buffered span and count events, oldest first."""
    return list(_events)


@contextmanager
def collect():
    """Records spans and counts inside the block, profiler or not, and
    yields the list that receives the block's events."""
    sink: list = []
    _sinks.append(sink)
    try:
        yield sink
    finally:
        del _sinks[next(i for i, s in enumerate(_sinks) if s is sink)]


def _rusage():
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_maxrss  # (cpu s, peak rss KiB)


def _fmt_hms(seconds: float) -> str:
    m, s = divmod(seconds, 60.0)
    h, m = divmod(int(m), 60)
    return (f"{h}:{m:02d}:{s:04.1f}" if h else f"{m}:{s:04.1f}")


class Tracer:
    """Owns one run's observability: log dir, joblog, profiler traces."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        profile: bool = False,
        echo: bool = True,
        timings: Optional[Dict[str, float]] = None,
    ):
        self.log_dir = log_dir
        self.profile = profile
        self.echo = echo
        self.timings: Dict[str, float] = timings if timings is not None else {}
        # stage -> {"peak_rss_mb", "peak_device_mb"}: the process's peaks at its end
        self.peaks: Dict[str, Dict[str, float]] = {}
        self._seq = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._joblog_path = os.path.join(log_dir, "joblog.tsv")
            if not os.path.exists(self._joblog_path):
                with open(self._joblog_path, "w") as f:
                    f.write("Seq\tStarttime\tJobRuntime\tCPU\tPeakRSSMb\tExitval\tCommand\n")
        else:
            self._joblog_path = None

    def _emit(self, stage: str, line: str) -> None:
        if self.echo:
            print(line, flush=True)
        if self.log_dir:
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in stage)
            with open(os.path.join(self.log_dir, f"{safe}.log"), "a") as f:
                f.write(line + "\n")

    def stage(self, name: str) -> "Stage":
        return Stage(self, name)

    def _record(self, name: str, t_start: float, wall: float, cpu: float,
                rss_kib: int, ok: bool) -> None:
        self.timings[name] = self.timings.get(name, 0.0) + wall
        self._seq += 1
        if self._joblog_path:
            with open(self._joblog_path, "a") as f:
                f.write(
                    f"{self._seq}\t{t_start:.3f}\t{wall:.3f}\t{cpu:.3f}"
                    f"\t{rss_kib / 1024:.1f}\t{0 if ok else 1}\t{name}\n"
                )


class Stage:
    """Context manager for one instrumented stage (one `execute` call)."""

    def __init__(self, tracer: Tracer, name: str):
        self.tr = tracer
        self.name = name
        self._prof = None
        self._span = None

    def __enter__(self):
        self.t0 = time.time()
        self.cpu0, _ = _rusage()
        self.tr._emit(self.name, f"[zkpoa] === {self.name} ... "
                      f"({time.strftime('%Y-%m-%d %H:%M:%S')})")
        if self.tr.profile and self.tr.log_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._span = span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._span.__exit__(exc_type, exc, tb)
        if self._prof is not None:
            self._prof.__exit__(exc_type, exc, tb)
            trace_dir = os.path.join(self.tr.log_dir, "torch_trace")
            os.makedirs(trace_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in self.name)
            self._prof.export_chrome_trace(os.path.join(trace_dir, f"{safe}.json"))
        wall = time.time() - self.t0
        cpu1, rss = _rusage()
        cpu = cpu1 - self.cpu0
        ok = exc_type is None
        pct = int(100 * cpu / wall) if wall > 0 else 0
        peak = {"peak_rss_mb": rss / 1024}
        device = ""
        if torch.cuda.is_initialized():
            peak["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
            device = f" ; peak-device {peak['peak_device_mb']:.0f}Mb"
        self.tr.peaks[self.name] = peak
        self.tr._emit(
            self.name,
            f"[zkpoa] === {self.name} {'done' if ok else 'FAILED'} | "
            f"STATS: time ({_fmt_hms(wall)}) {wall:.2f}s ; cpu {cpu:.2f}s {pct}% ; "
            f"peak-rss {rss / 1024:.0f}Mb{device}",
        )
        self.tr._record(self.name, self.t0, wall, cpu, rss, ok)
        return False
