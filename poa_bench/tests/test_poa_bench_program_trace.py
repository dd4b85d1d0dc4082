"""The readers of the program's own spans and counts (`progtrace.py`,
`metrics/span_mean.py`, `counter_mean.py`, `span_idle.py`) on synthetic
events, requests and traces; on the card, the program's `h2d_bytes` of
a layer-one prove against the profiler's copies (its `host_sync` count is
held to PyTorch's sync debug mode in `tests/test_torch_cuda.py`). Run the
card tests there with `python3 -m pytest poa_bench/tests -m cuda -q`."""

import json
from collections import Counter

import pytest

from poa_bench import devtrace, progtrace
from poa_bench.metrics import counter_mean, span_idle, span_mean
from poa_bench.pool import Request, RunData

CONVERT = ["prove.upload.reduce", "prove.upload.limbs"]
OFFSET_US = 5_000_000.0  # trace clock less host clock in the synthetic runs


def span(sid, name, t0_s, t1_s, prove, parent=None):
    return {"kind": "span", "name": name, "id": sid, "parent": parent, "prove": prove,
            "t0": round(t0_s * 1e9), "t1": round(t1_s * 1e9)}


def count(name, n, site, prove):
    return {"kind": "count", "name": name, "site": site, "n": n, "t": 0, "span": prove,
            "prove": prove}


def prove_events(pid, t0):
    """One prove from t0 (s): conversion 0.2 s (0.05 reduce, 0.15 limbs),
    copy, then device work."""
    return [span(pid + 1, "prove.upload.reduce", t0 + 0.10, t0 + 0.15, pid, pid),
            span(pid + 2, "prove.upload.limbs", t0 + 0.15, t0 + 0.30, pid, pid),
            span(pid + 3, "prove.upload.copy", t0 + 0.30, t0 + 0.32, pid, pid),
            count("h2d_bytes", 1_000_000, "witness", pid),
            count("h2d_bytes", 2_500_000, "spmv_index", pid),
            count("host_sync", 1, "witness", pid), count("host_sync", 3, "plan.bincount", pid),
            count("host_sync", 7, "prove.phase", pid),
            span(pid, "prove", t0 + 0.05, t0 + 0.90, pid)]


def request(i, t0, marks=()):
    return Request(i=i, wi=0, r=1, s=2, t_start=t0, t_end=t0 + 1.0, proof=("a", "b", "c"),
                   phases=[(name, t0 + dt) for name, dt in marks])


MARKS = [("witness upload", 0.33), ("QAP SpMV", 0.40), ("assembly", 0.85)]


def traced_run(jitter_us=(0.0, 0.0, 0.0), jitter_r1_us=None):
    """Two requests at 10 s and 11 s; phase ranges end at their marks on
    the trace clock (plus jitter, request 1's its own where given), the
    device busy after each upload."""
    reqs = [request(0, 10.0, MARKS), request(1, 11.0, MARKS)]
    phases, device = [], []
    for req, jitter in zip(reqs, (jitter_us, jitter_r1_us or jitter_us)):
        start = req.t_start * 1e6 + OFFSET_US
        for (name, t), jit in zip(req.phases, jitter):
            end = t * 1e6 + OFFSET_US + jit
            phases.append((req.i, name, start, end))
            start = end
        phases.append((req.i, "return", start, req.t_end * 1e6 + OFFSET_US))
        t0 = req.t_start * 1e6 + OFFSET_US
        device.append({"ts": t0 + 0.32e6, "dur": 0.5e6, "name": "k", "cat": "kernel"})
        device.append({"ts": t0 + 0.20e6, "dur": 0.05e6, "name": "m", "cat": "gpu_memcpy"})
    window = (10.0e6 + OFFSET_US, 12.0e6 + OFFSET_US)
    tr = devtrace.Trace(window=window, device=device, phases=sorted(phases, key=lambda p: p[2]))
    return RunData(requests=reqs, setup_s=1.0, ctx=None, trace=tr)


@pytest.fixture
def events(monkeypatch):
    def install(evs):
        monkeypatch.setattr(progtrace, "program_events", lambda: list(evs))
    return install


def test_proves_are_tied_to_their_requests(events):
    stale = prove_events(100, 2.0)  # a prove traced earlier in the process
    events(stale + prove_events(10, 10.0) + prove_events(20, 11.0) + [count("x", 1, "s", None)])
    data = traced_run()
    got = progtrace.by_request(data)
    assert [req.i for req, _ in got] == [0, 1]
    assert {e["prove"] for e in got[0][1]} == {10} and {e["prove"] for e in got[1][1]} == {20}
    data.requests[1].proof = None
    assert [req.i for req, _ in progtrace.by_request(data)] == [0]


def test_witness_convert_ms_is_the_mean_conversion_time(events):
    events(prove_events(10, 10.0) + prove_events(20, 11.0))
    spec = {"spans": CONVERT, "scale": 1e-6}
    assert span_mean.read(spec, traced_run()) == pytest.approx(200.0)
    assert span_mean.read({"spans": ["prove.upload.copy"], "scale": 1e-6}, traced_run()) \
        == pytest.approx(20.0)
    assert span_mean.read({"spans": ["absent"]}, traced_run()) is None


def test_counter_means_by_site(events):
    events(prove_events(10, 10.0) + prove_events(20, 11.0))
    assert counter_mean.read({"counter": "h2d_bytes", "scale": 1e-6}, traced_run()) \
        == pytest.approx(3.5)
    syncs = {"counter": "host_sync", "except_sites": ["prove.phase"]}
    assert counter_mean.read(syncs, traced_run()) == 4
    assert counter_mean.read({"counter": "host_sync"}, traced_run()) == 11
    assert counter_mean.read({"counter": "absent"}, traced_run()) is None


def test_idle_in_conversion_on_the_trace_clock(events):
    events(prove_events(10, 10.0) + prove_events(20, 11.0))
    spec = {"spans": CONVERT}
    # each request: conversion [0.10, 0.30] s, the copy [0.20, 0.25] busy, so 0.15 s idle
    assert span_idle.read(spec, traced_run()) == pytest.approx(100 * 0.30 / 2.0)
    data = traced_run(jitter_us=(0.0, 150.0, -40.0))
    assert progtrace.trace_offset_us(data) == pytest.approx(OFFSET_US, abs=1e-3)
    assert span_idle.read(spec, data) == pytest.approx(100 * 0.30 / 2.0)


def test_the_clock_offset_is_refused_past_200_us(events):
    """The spread is the distance between the quartiles: a mark late once
    moves neither the offset nor the verdict."""
    events(prove_events(10, 10.0) + prove_events(20, 11.0))
    data = traced_run(jitter_us=(0.0, 201.0, 0.0))
    assert progtrace.trace_offset_us(data) is None
    assert span_idle.read({"spans": CONVERT}, data) is None
    assert progtrace.trace_offset_us(traced_run(jitter_us=(0.0, 199.0, 0.0))) is not None
    once = traced_run(jitter_us=(0.0, 0.0, 0.0), jitter_r1_us=(0.0, 0.0, 500.0))
    assert progtrace.trace_offset_us(once) == pytest.approx(OFFSET_US, abs=1e-3)


def test_no_program_events_reads_none(events):
    events([])
    data = traced_run()
    assert span_mean.read({"spans": CONVERT}, data) is None
    assert counter_mean.read({"counter": "h2d_bytes"}, data) is None
    assert span_idle.read({"spans": CONVERT}, data) is None
    events(prove_events(10, 10.0))
    assert span_idle.read({"spans": CONVERT}, RunData(data.requests, 1.0, None)) is None


def test_a_program_without_the_buffer_reads_none(monkeypatch):
    from zkpoa_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "events")
    assert progtrace.program_events() == []
    assert counter_mean.read({"counter": "h2d_bytes"}, traced_run()) is None


def test_overlap_of_interval_lists():
    assert progtrace.overlap_us([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 12
    assert progtrace.overlap_us([], [(0, 1)]) == 0


def test_the_toy_cells_traced_block_reports_the_program_metrics(monkeypatch, tmp_path):
    import torch

    import toy
    from poa_bench import run

    torch.set_num_threads(2)
    bench, pkg = toy.install(monkeypatch, tmp_path)
    res = run.run_cell(bench, "toy.run", 3100000033, 0.01, True, "cpu", pkg=pkg)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < got["witness_convert_ms.prove"] < got["upload_ms.prove"]
    assert got["h2d_mb.prove"] > 0 and got["host_syncs.prove"] > 0
    assert 0 < got["idle_convert_pct.prove"] < 100


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer_one():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from poa_bench.circuits import layer_one as L1
    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    system, witness, _raw = L1.build_one({"n_sigs": 2}, "program-trace|batch0")
    key = setup_device(system, "cuda", seed="program-trace|key")
    prove(key, system, witness, "cuda", r=1, s=2)  # kernels built, constants on the card
    torch.cuda.synchronize()
    return key, system, witness


def _sites(events, name):
    out = {}
    for e in events:
        if e["kind"] == "count" and e["name"] == name:
            out[e["site"]] = out.get(e["site"], 0) + e["n"]
    return out


@pytest.mark.cuda
def test_h2d_bytes_are_the_copies_the_profiler_sees(layer_one):
    """The counted bytes are those worked out from the packed system and
    the witness, and each copy the profiler records is one counted copy
    of the counted size (the index arrays at 8 bytes an entry). The
    profiler at times records no event for a copy (the witness copy, in
    two of four runs on an H100), so its records are matched one by one,
    one missing allowed, not summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.utils import trace

    key, system, witness = layer_one
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            trace.collect() as events:
        prove(key, system, witness, "cuda", r=5, s=6)
        torch.cuda.synchronize()
    seen = [e["args"]["bytes"] for e in json.loads(_chrome(prof))["traceEvents"]
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
            and e.get("args", {}).get("bytes", 0) >= 1 << 16]
    copies = [e["n"] for e in events if e["kind"] == "count" and e["name"] == "h2d_bytes"]
    packed = system.pack()
    mats = (packed.a, packed.b, packed.c)
    want = 32 * len(witness) + 3 * 8 * sum(len(m.idx) for m in mats) + packed.pool_limbs.nbytes
    print(json.dumps({"counted": _sites(events, "h2d_bytes"), "worked_out": want,
                      "copies": sorted(copies), "profiler_copies": sorted(seen)}))
    assert sum(copies) == want
    left = Counter(copies)
    for b in seen:
        assert left[b] > 0, (b, sorted(copies))
        left[b] -= 1
    assert {8 * len(m.idx) for m in mats} & set(seen)
    assert len(seen) >= len(copies) - 1


def _chrome(prof) -> str:
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return f.read()
    finally:
        os.unlink(path)
