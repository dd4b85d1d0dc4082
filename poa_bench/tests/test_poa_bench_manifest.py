"""BENCHMARK.json against the contract's form, and every file a cell needs
found by name."""

import importlib
import json
import os
import re

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["poa_bench"]
    assert bench["command"] == ["python3", "-m", "poa_bench.run"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in bench["workloads"]] \
        + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]] \
            + [m["layer"] for m in bench["per_layer"]] + [c["source"] for c in bench["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_keys_bounds_and_sources(bench):
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def reports(bench, metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_every_per_layer_cell_reports_what_it_moves(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert reports(bench, e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if reports(bench, m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(bench, m, w["name"]) for m in bench["per_layer"])
        assert w["chips"] == 1


@pytest.mark.parametrize("cell", ["l1_b2.prove", "l2r_b2_h12.prove"])
def test_cell_files_found_by_name(bench, cell):
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    with open(os.path.join(PKG, "workloads", f"{cell}.json")) as f:
        spec = json.load(f)
    assert spec["config"] == entry["config"] and spec["traffic"] == entry["traffic"]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    assert config["reduced"] == conf["reduced"] == []
    assert config["source"] == conf["source"]
    assert callable(importlib.import_module(f"poa_bench.circuits.{config['circuit']}").build_pool)
    assert callable(importlib.import_module(f"poa_bench.reference.{config['circuit']}")
                    .expected_publics)
    assert callable(importlib.import_module(f"poa_bench.traffic.{spec['traffic']}").serve)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not reports(bench, m, cell):
            continue
        with open(os.path.join(PKG, "specs", f"{m['name']}.json")) as f:
            mspec = json.load(f)
        assert callable(importlib.import_module(f"poa_bench.metrics.{mspec['reader']}").read)
        if "work" in mspec:
            assert callable(importlib.import_module(f"poa_bench.work.{mspec['work']}").work)


def test_sig_batches_traffic_and_its_batch_build_exist():
    assert callable(importlib.import_module("poa_bench.traffic.sig_batches").serve)
    assert callable(importlib.import_module("poa_bench.circuits.layer_one").build_one)
