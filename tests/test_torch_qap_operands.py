"""The SpMV operands of `zkpoa_tpu_torch/ops/qap_eval.py` kept with their
packed system: copied to a device at the system's first evaluation there
(setup's, as a rule), taken from there by every later evaluation, each
prove's among them, and freed with the system. CHUNK_ROWS is cut to 8 rows,
so every evaluation crosses chunk boundaries."""

import gc
import weakref

import numpy as np
import pytest
import torch

from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.fields.bn254 import R
from zkpoa_tpu_torch.models import r1cs
from zkpoa_tpu_torch.ops import qap_eval as Q
from zkpoa_tpu_torch.ops.limbs import BN254_FR
from zkpoa_tpu_torch.prover import groth16
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import setup_device
from zkpoa_tpu_torch.utils import trace

torch.set_num_threads(1)

CPU = torch.device("cpu")
RS = (0x1234567, 0x89ABCDEF)


def _circuit():
    """A product of 13 values: 13 constraints, 27 wires, 39 A/B/C rows."""
    c = r1cs.Circuit()
    out = c.public_output()
    acc = c.var(3)
    for k in range(12):
        acc = c.mul(acc, c.var(k + 2))
    c.bind_output(out, acc)
    return c.compile()


def counts(events, name):
    out = {}
    for e in events:
        if e["kind"] == "count" and e["name"] == name:
            out[e["site"]] = out.get(e["site"], 0) + e["n"]
    return out


def _operand_bytes(packed):
    return packed.pool_limbs.nbytes + sum(
        a.nbytes for m in (packed.a, packed.b, packed.c) for a in (m.idx, m.wire, m.cid))


def _tensors(system):
    mats, pool = system.pack()._spmv_operands[CPU]
    return [t for mat in mats for t in mat] + [pool]


@pytest.fixture(autouse=True)
def short_chunks(monkeypatch):
    monkeypatch.setattr(Q, "CHUNK_ROWS", 8)


@pytest.fixture(scope="module", params=["monomial", "coset"])
def runs(request):
    """In one H basis: a setup and two proves of system A, each under
    collect(), then a prove of B, the same circuit compiled again (so its
    first evaluation is the prove's own), with A's key and the same (r, s);
    then B is deleted and weakrefs to its operands are read."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Q, "CHUNK_ROWS", 8)
        system, witness = _circuit()
        fresh, fresh_witness = _circuit()
        out = {"system": system, "witness": witness, "fresh_bytes": _operand_bytes(fresh.pack())}
        with trace.collect() as events:
            key = setup_device(system, "cpu", seed="operands", h_basis=request.param)
        out["setup"], out["key"] = events, key
        for k in (1, 2):
            with trace.collect() as events:
                out[f"proof{k}"] = prove(key, system, witness, "cpu", r=RS[0], s=RS[1])
            out[f"prove{k}"] = events
        with trace.collect() as events:
            out["fresh_proof"] = prove(key, fresh, fresh_witness, "cpu", r=RS[0], s=RS[1])
        out["fresh"] = events
        out["distinct"] = not any(a is b for a, b in zip(_tensors(fresh), _tensors(system)))
        refs = [weakref.ref(t) for t in _tensors(fresh)]
        out["alive_before"] = [r() is not None for r in refs]
        del fresh
        gc.collect()
        out["alive_after"] = [r() is not None for r in refs]
    return out


def test_a_setup_fills_the_operands_once_and_each_prove_finds_them(runs):
    packed = runs["system"].pack()
    assert counts(runs["setup"], "spmv_operands") == {"fill": 1}
    assert counts(runs["setup"], "h2d_bytes") == {"spmv_operands": _operand_bytes(packed)}
    assert counts(runs["setup"], "host_sync") == {"spmv_operands": 10}
    for k in (1, 2):
        assert counts(runs[f"prove{k}"], "spmv_operands") == {"hit": 1}


def test_a_prove_copies_its_witness_alone(runs):
    want = {"witness": host.scalars_to_limbs_fast(runs["witness"]).nbytes}
    for k in (1, 2):
        assert counts(runs[f"prove{k}"], "h2d_bytes") == want
        syncs = counts(runs[f"prove{k}"], "host_sync")
        assert syncs["witness"] == 1
        assert not any(site.startswith("spmv") for site in syncs)


def test_a_second_system_fills_its_own_operands(runs):
    events = runs["fresh"]
    assert counts(events, "spmv_operands") == {"fill": 1}
    assert counts(events, "h2d_bytes") == {
        "witness": host.scalars_to_limbs_fast(runs["witness"]).nbytes,
        "spmv_operands": runs["fresh_bytes"]}
    assert counts(events, "host_sync")["spmv_operands"] == 10
    assert runs["distinct"]


def test_proofs_on_kept_operands_equal_a_fresh_evaluation(runs):
    a, b, fresh = runs["proof1"], runs["proof2"], runs["fresh_proof"]
    assert (a.pi_a, a.pi_b, a.pi_c) == (fresh.pi_a, fresh.pi_b, fresh.pi_c)
    assert (b.pi_a, b.pi_b, b.pi_c) == (fresh.pi_a, fresh.pi_b, fresh.pi_c)
    vk = groth16.VerifyingKey.from_json(runs["key"].vk_json)
    system, witness = runs["system"], runs["witness"]
    assert groth16.verify(vk, a, [witness[w] for w in range(1, system.n_public + 1)])


def test_the_operands_are_freed_with_their_system(runs):
    assert all(runs["alive_before"]) and len(runs["alive_before"]) == 10
    assert not any(runs["alive_after"])


def test_the_kept_operands_are_the_packed_int32_arrays_and_the_mont_pool(runs):
    packed = runs["system"].pack()
    assert list(packed._spmv_operands) == [CPU]
    mats, pool = packed._spmv_operands[CPU]
    for (idx, wire, cid), m in zip(mats, (packed.a, packed.b, packed.c)):
        for t, a in ((idx, m.idx), (wire, m.wire), (cid, m.cid)):
            assert t.dtype == torch.int32 and t.device == CPU
            assert np.array_equal(t.numpy(), a)
    assert torch.equal(BN254_FR.from_mont(pool), torch.from_numpy(packed.pool_limbs))


def test_evaluations_on_kept_operands_equal_the_host_rows():
    """Both directions on a hit, to exact host sums: the prover's
    <A_i, w> (scatter = constraint) and setup's per-wire values at the
    Lagrange points (scatter = wire)."""
    system, witness = _circuit()
    packed = system.pack()
    w = torch.from_numpy(host.scalars_to_limbs_fast(witness))
    lag_vals = [(7 ** (i + 3) + i) % R for i in range(16)]
    lag = torch.from_numpy(host.scalars_to_limbs_fast(lag_vals))
    with trace.collect() as events:
        firsts = Q.eval_matrices_device(packed, w, 16), Q.eval_at_tau_device(packed, lag, 27)
        seconds = Q.eval_matrices_device(packed, w, 16), Q.eval_at_tau_device(packed, lag, 27)
    assert counts(events, "spmv_operands") == {"fill": 1, "hit": 3}
    want_m = [v + [0] * (16 - len(v)) for v in system.eval_matrices(witness)]
    want_t = []
    for rows in (system.a_rows, system.b_rows, system.c_rows):
        out = [0] * system.n_wires
        for i, wire, coeff in rows:
            out[wire] = (out[wire] + coeff * lag_vals[i]) % R
        want_t.append(out)
    for ev_m, ev_t in (firsts, seconds):
        assert [BN254_FR.from_limbs(x) for x in ev_m] == want_m
        assert [BN254_FR.from_limbs(x) for x in ev_t] == want_t
