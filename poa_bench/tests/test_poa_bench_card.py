"""The toy cell on the card: the program's kernels, the profiler's device
trace and the reference on CUDA. Run there with
`python3 -m pytest poa_bench/tests -m cuda -q`."""

import pytest

import toy
from poa_bench import run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def test_toy_cell_window_on_the_card(card, monkeypatch, tmp_path):
    bench, pkg = toy.install(monkeypatch, tmp_path, warmup=1)
    res = run.run_cell(bench, "toy.run", 5000000029, 2.0, False, card, pkg=pkg)
    assert res["correct"] and res["attempted"] >= 2
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


def test_toy_cell_trace_on_the_card(card, monkeypatch, tmp_path):
    bench, pkg = toy.install(monkeypatch, tmp_path, warmup=1, traced=2)
    res = run.run_cell(bench, "toy.run", 5000000039, 1.0, True, card, pkg=pkg)
    assert res["correct"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > res["device"]["busy_s"]
    for name in ("upload_ms.prove", "msm_ms.prove", "idle_pct.prove", "ntt_roofline",
                 "msm_roofline"):
        assert name in res["metrics"], name
    assert 0 < res["metrics"]["ntt_roofline"]["value"] <= 100
    assert res["breakdown"]["device_ops"]
