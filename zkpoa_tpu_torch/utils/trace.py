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
"""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, Optional

import torch


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
        return self

    def __exit__(self, exc_type, exc, tb):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
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
