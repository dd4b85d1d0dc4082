"""A whole run of a toy cell on the CPU through an injected device: the
window, the traced block, the judge; faults planted under the timed path
and the control come out not correct; the signature-batch traffic; and
the command itself refuses without a card."""

import json

import pytest
import torch

import toy
from poa_bench import control, run
from zkpoa_tpu_torch.prover.prove import prove as program_prove

SEED = 3000000019  # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def cell(monkeypatch, tmp_path):
    return toy.install(monkeypatch, tmp_path)


def run_toy(bench, pkg, trace=False, prove=None):
    return run.run_cell(bench, "toy.run", SEED, 0.01, trace, "cpu", prove=prove, pkg=pkg)


def test_window_is_correct_and_reports_its_metrics(cell):
    res = run_toy(*cell)
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s"}  # one proof: no tail
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"answers_wrong": {"value": 0, "limit": 0}}
    json.dumps(res)


def test_traced_block_reads_phases(cell):
    res = run_toy(*cell, trace=True)
    assert res["correct"]
    assert res["metrics"]["upload_ms.prove"]["value"] > 0
    assert res["metrics"]["msm_ms.prove"]["value"] > 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def broken(fault):
    """The program's prove with one fault planted where it produces."""
    first = {}

    def call(key, r1cs, witness, r, s, log=None):
        if fault == "half_left_out":
            witness = list(witness[: len(witness) // 2]) + [0] * (len(witness) - len(witness) // 2)
        p = first.get("p") if fault == "state_unchanged" else None
        if p is None:
            p = program_prove(key, r1cs, witness, "cpu", r=r, s=s, log=log)
            first["p"] = p
        pts = (p.pi_a, p.pi_b, p.pi_c)
        if fault == "answer_altered":
            from poa_bench.reference import bn254
            pts = (pts[0], pts[1], bn254.g1_add(pts[2], bn254.G1_GEN))
        return pts
    return call


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "state_unchanged"])
def test_planted_faults_come_out_not_correct(cell, monkeypatch, fault):
    bench, pkg = cell
    if fault == "state_unchanged":  # needs a second request to repeat the first answer
        monkeypatch.setattr(run, "window", lambda ctx, serve, s: [serve(ctx, 0), serve(ctx, 1)])
    res = run_toy(bench, pkg, prove=broken(fault))
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["answers_wrong"]["value"] >= 1


def test_a_public_value_altered_in_set_up_is_not_correct(cell, monkeypatch):
    built = toy.build_pool

    def build_pool(*a):
        pool = built(*a)
        pool.witnesses[1] = list(pool.witnesses[1])  # a witness the window does not serve
        pool.witnesses[1][1] += 1  # its public output wire
        return pool
    monkeypatch.setattr(toy, "build_pool", build_pool)
    res = run_toy(*cell)
    assert not res["correct"] and res["failed"] == 0
    assert res["checks"]["answers_wrong"]["value"] == 1


def test_a_request_that_raises_is_a_missing_answer(cell):
    def raising(*a, **k):
        raise RuntimeError("device lost")
    res = run_toy(*cell, prove=raising)
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"]["answers_wrong"]["value"] == 1


def test_control_comes_out_not_correct(cell):
    bench, pkg = cell
    out = control.control("toy.run", SEED, 4, "cpu", pkg=pkg)
    assert not out["correct"] and out["checks"] == {"answers_wrong": 4}
    assert out["parts"]["proofs_wrong"] == 4


def test_sig_batches_builds_and_proves_each_request(monkeypatch, tmp_path):
    bench, pkg = toy.install(monkeypatch, tmp_path, traffic="sig_batches")
    res = run.run_cell(bench, "toy.run", SEED, 0.01, True, "cpu", pkg=pkg)
    assert res["correct"] and res["attempted"] == 1
    assert res["breakdown"]["idle_gaps"]


def test_command_refuses_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert run.main(["--workload", "l1_b2.prove", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
