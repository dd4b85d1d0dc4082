"""The metric readers on synthetic requests, spans and traces."""

import statistics
import types

import pytest

from poa_bench import devtrace
from poa_bench.metrics import (idle_share, kernel_roofline, latency_quantile, phase_mean,
                               rate, setup)
from poa_bench.pool import Request, RunData


def req(i, t0, t1, phases=(), proof=("a", "b", "c")):
    return Request(i=i, wi=0, r=1, s=2, t_start=t0, t_end=t1, proof=proof, phases=list(phases))


def data(requests, trace=None, peaks=None, ctx=None):
    return RunData(requests=requests, setup_s=12.5, ctx=ctx, trace=trace, peaks=peaks)


def dev(ts, dur, name="k", cat="kernel"):
    return {"ts": ts, "dur": dur, "name": name, "cat": cat}


def test_busy_union_counts_overlaps_once():
    events = [dev(0, 10), dev(5, 10), dev(30, 5), dev(31, 2), dev(40, 0)]
    assert devtrace.busy_us(events) == 20
    assert devtrace.union(events) == [(0, 15), (30, 35), (40, 40)]
    assert devtrace.clip(events, 8, 32) == [dev(8, 2), dev(8, 7), dev(30, 2), dev(31, 1)]


def test_idle_share_over_the_traced_window():
    tr = devtrace.Trace(window=(0, 100), device=[dev(-5, 10), dev(20, 30), dev(40, 20),
                                                   dev(95, 20, cat="gpu_memcpy")],
                        phases=[])
    assert idle_share.read({}, data([], tr)) == pytest.approx(100 * (1 - (5 + 40 + 5) / 100))
    assert idle_share.read({}, data([], devtrace.Trace((0, 1), [], []))) is None
    assert idle_share.read({}, data([])) is None


def test_rate_over_whole_requests_and_their_span():
    rs = [req(0, 10.0, 11.0), req(1, 11.0, 13.5), req(2, 13.5, 14.0)]
    assert rate.read({}, data(rs)) == pytest.approx(3 / 4.0)
    failed = rs + [req(3, 14.0, 0.0, proof=None)]
    assert rate.read({}, data(failed)) == pytest.approx(3 / 4.0)
    assert rate.read({}, data([req(0, 1, 2, proof=None)])) is None


def test_tail_over_every_request():
    lat = [0.9 + 0.01 * k for k in range(40)] + [3.0]
    rs = [req(k, 100.0 * k, 100.0 * k + v) for k, v in enumerate(lat)]
    got = latency_quantile.read({"q": 0.95, "min_requests": 20}, data(rs))
    assert got == pytest.approx(statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert latency_quantile.read({"q": 0.95, "min_requests": 50}, data(rs)) is None


def test_setup_reads_the_run():
    assert setup.read({}, data([])) == 12.5


def test_phase_mean_sums_matching_phases_per_request():
    ph = [("witness upload", 1.5), ("QAP SpMV", 1.6), ("MSM plans (c=11/13, 8 heavy values)", 1.7),
          ("a/b1/c/h G1 MSMs", 1.9), ("b2 G2 MSM", 2.0), ("assembly", 2.1)]
    rs = [req(0, 1.0, 2.2, ph), req(1, 3.0, 4.2, [(n, t + 2.0) for n, t in ph])]
    assert phase_mean.read({"phases": ["witness upload"], "scale": 1000}, data(rs)) \
        == pytest.approx(500.0)
    msm = {"phases": ["MSM plans", "a/b1/c/h G1 MSMs", "b2 G2 MSM"], "scale": 1000}
    assert phase_mean.read(msm, data(rs)) == pytest.approx(400.0)
    assert phase_mean.read({"phases": ["no such phase"]}, data(rs)) is None


def test_phase_names_from_the_program_log():
    assert devtrace.phase_name("prove: witness upload 0.563s") == "witness upload"
    assert devtrace.phase_name("prove: MSM plans (c=11/13, 8 heavy values) 1.2s") \
        == "MSM plans (c=11/13, 8 heavy values)"
    assert devtrace.phase_name("poa_bench: witness build") == "witness build"


def test_kernel_roofline_reads_kernels_inside_phases(monkeypatch):
    work = types.SimpleNamespace(work=lambda ctx, r: (2e9, 1e6))
    monkeypatch.setitem(__import__("sys").modules, "poa_bench.work.fake", work)
    tr = devtrace.Trace(window=(0, 1000), device=[
        dev(10, 100, "void ntt_pass_kernel<1>(int)"), dev(200, 300, "msm_piece_kernel"),
        dev(600, 100, "ntt_pass_kernel"), dev(900, 50, "ntt_pass_kernel", cat="gpu_memcpy")],
        phases=[(0, "quotient h(X)", 0, 150), (0, "MSM plans", 150, 550),
                (1, "quotient h(X)", 550, 800)])
    peaks = {"int32_ops_s": 1e13, "bytes_s": 1e12}
    rs = [req(0, 0, 1), req(1, 1, 2)]
    ntt = kernel_roofline.read({"work": "fake", "kernels": ["ntt_pass_kernel"]},
                               data(rs, tr, peaks))
    assert ntt == pytest.approx(100 * 2 * 2e-4 / 200e-6)
    msm = kernel_roofline.read({"work": "fake", "phases": ["MSM plans"]}, data(rs, tr, peaks))
    assert msm == pytest.approx(100 * 2 * 2e-4 / 300e-6)
    assert kernel_roofline.read({"work": "fake", "kernels": ["absent"]}, data(rs, tr, peaks)) \
        is None
    assert kernel_roofline.read({"work": "fake"}, data(rs, tr, None)) is None


def test_breakdown_labels_gaps_with_the_host_phase():
    tr = devtrace.Trace(window=(0, 1000), device=[dev(100, 100, "a"), dev(150, 100, "b"),
                                                   dev(900, 50, "a")],
                        phases=[(0, "witness upload", 0, 600), (0, "QAP SpMV", 600, 1000)])
    bd = devtrace.breakdown(tr)
    assert [n for n, _ in bd["device_ops"]] == ["a", "b"]
    assert [s for _, s in bd["device_ops"]] == pytest.approx([150e-6, 100e-6])
    assert [n for n, _ in bd["idle_gaps"]] == ["r0: witness upload", "r0: witness upload",
                                               "r0: QAP SpMV"]
    assert [s for _, s in bd["idle_gaps"]] == pytest.approx([650e-6, 100e-6, 50e-6])
