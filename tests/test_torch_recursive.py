"""The recursive mode of the port on the CPU, from the recorded two-signature
chain (`build/recursive_run2/2_sigs_2_batches_5_height`, proved by the JAX
package), at the sizes a test can afford (the in-snark verifier itself is
about 7M constraints: it runs on the card, in `chip_smoke.py` and in
`python -m zkpoa_tpu_torch.experiments.run_recursive`).

1. `PreparedVK.from_vk` of the recorded layer-one verifying key equals the
   JAX package's field for field (comb tables, Miller lines, the
   final-exponentiation constant, the comb offset).
2. The in-snark Groth16 verifier refuses a tampered public input while it
   builds the witness (`ValueError`: no residue witness exists), in both
   packages, as `tests/test_pairing_gadget.py` shows for the JAX package.
3. The workflow's `_layer_two_input` with the sanitized layer-one proof
   equals the JAX workflow's and, written out, the recorded
   `layer_two_input.json` byte for byte; `load_layer_two_input` reads the
   same input back from a batch directory, and the recursive layer two
   refuses an input without a proof.
4. The runner's recorded-output check passes on the recorded directory and
   fails on a copy with one tampered layer-three value (or a tampered
   batch public value, or a missing file).
5. The runner refuses to write under `build/recursive_run*/`.
Exact comparisons throughout."""

import dataclasses
import json
import os
import shutil

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU)

from zkpoa_tpu.models.gadgets import pairing_gadget as JPG
from zkpoa_tpu.models.r1cs import Circuit as JCircuit
from zkpoa_tpu.pipeline import sigs as jax_sigs
from zkpoa_tpu.pipeline import workflow as jax_workflow
from zkpoa_tpu.prover import groth16 as jax_groth16
from zkpoa_tpu_torch.experiments import run_recursive as RR
from zkpoa_tpu_torch.merkle.tree import MerkleTree, find_owned_indices
from zkpoa_tpu_torch.models.gadgets import pairing_gadget as PG
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.pipeline import sigs, workflow
from zkpoa_tpu_torch.prover import groth16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN2 = os.path.join(REPO, "build", "recursive_run2")
GOLDEN = os.path.join(RUN2, "2_sigs_2_batches_5_height")


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def prepared():
    vk = _load(GOLDEN, "batch_0", "layer_one_vkey.json")
    return (PG.PreparedVK.from_vk(groth16.VerifyingKey.from_json(vk)),
            JPG.PreparedVK.from_vk(jax_groth16.VerifyingKey.from_json(vk)))


def test_prepared_vk_equals_the_jax_packages(prepared):
    port, jax_ = prepared
    names = [f.name for f in dataclasses.fields(PG.PreparedVK)]
    assert names == [f.name for f in dataclasses.fields(JPG.PreparedVK)]
    for name in names:
        assert getattr(port, name) == getattr(jax_, name), name
    assert len(port.ic) == 2 and len(port.gamma_lines) == len(port.delta_lines) > 0


@pytest.mark.parametrize("batch", [0, 1])
@pytest.mark.parametrize("delta", [1, -1])
def test_in_snark_verifier_refuses_a_tampered_public_input(prepared, batch, delta):
    san = _load(GOLDEN, f"batch_{batch}", "layer_one_sanitized_proof.json")
    if batch == 1:  # batch 1's own key: the recorded layer-one key is shared by both batches
        assert _load(GOLDEN, "batch_1", "layer_one_vkey.json") == _load(
            GOLDEN, "batch_0", "layer_one_vkey.json")
    for pg, circuit, pvk in ((PG, Circuit, prepared[0]), (JPG, JCircuit, prepared[1])):
        c = circuit(check=False)
        negpa, pb, pc = pg.proof_signals_from_sanitized(c, san)
        public = [c.var(int(san["pubInput"][0]) + delta)]
        with pytest.raises(ValueError):
            pg.groth16_verify_gadget(c, pvk, negpa, pb, pc, public)


@pytest.mark.parametrize("batch", [0, 1])
def test_layer_two_input_with_proof_equals_the_jax_workflows(batch):
    addrs, bals = workflow.load_anon_set(os.path.join(RUN2, "anon.csv"))
    tree = MerkleTree.build(addrs, bals, 5, device="cpu")
    atts = sigs.parse_signatures_file(os.path.join(RUN2, "sigs.json"))
    jatts = jax_sigs.parse_signatures_file(os.path.join(RUN2, "sigs.json"))
    idx = find_owned_indices(addrs, [a.address for a in atts])
    proofs = [tree.prove(idx[batch])]
    san = _load(GOLDEN, f"batch_{batch}", "layer_one_sanitized_proof.json")
    mine = workflow._layer_two_input(atts[batch:batch + 1], proofs, tree.root(), 5)
    theirs = jax_workflow._layer_two_input(jatts[batch:batch + 1], proofs, tree.root(), 5)
    mine.proof = san
    theirs.proof = san
    got = workflow._jsonable(mine.__dict__)
    assert got == jax_workflow._jsonable(theirs.__dict__)
    with open(os.path.join(GOLDEN, f"batch_{batch}", "layer_two_input.json")) as f:
        assert json.dumps(got) == f.read()


@pytest.mark.parametrize("batch", [0, 1])
def test_layer_two_input_loads_from_a_batch_directory(batch):
    """The input `chip_smoke.py` proves the recursive layer two from: the
    recorded batch directory read back equals the workflow's own input."""
    addrs, bals = workflow.load_anon_set(os.path.join(RUN2, "anon.csv"))
    tree = MerkleTree.build(addrs, bals, 5, device="cpu")
    atts = sigs.parse_signatures_file(os.path.join(RUN2, "sigs.json"))
    idx = find_owned_indices(addrs, [a.address for a in atts])
    want = workflow._layer_two_input(atts[batch:batch + 1], [tree.prove(idx[batch])],
                                     tree.root(), 5)
    bdir = os.path.join(GOLDEN, f"batch_{batch}")
    want.proof = _load(bdir, "layer_one_sanitized_proof.json")
    got, vk1 = workflow.load_layer_two_input(bdir)
    assert got == want
    assert vk1 == _load(bdir, "layer_one_vkey.json")
    got.proof = None
    with pytest.raises(ValueError):
        workflow.recursive_layer_two_circuit(got, vk1, 5)


def test_recorded_check_passes_on_the_recorded_run():
    rec = RR.check_against_recorded(GOLDEN, GOLDEN)
    assert rec["ok"] and rec["layer_three_public"] and rec["balance_sum"]
    assert set(rec) == {"merkle_root", "balance_sum", "batch_0_public", "batch_1_public",
                        "layer_three_public", "ok"}


@pytest.mark.parametrize("tamper", ["layer_three", "batch_1", "missing"])
def test_recorded_check_fails_on_a_tampered_copy(tmp_path, tamper):
    copy = str(tmp_path / "run")
    shutil.copytree(GOLDEN, copy)
    if tamper == "layer_three":
        path = os.path.join(copy, "layer_three", "public.json")
        vals = _load(path)
        vals[5] = str(int(vals[5]) + 1)
    elif tamper == "batch_1":
        path = os.path.join(copy, "batch_1", "public.json")
        vals = _load(path)
        vals[0] = str(int(vals[0]) - 1)
    else:
        os.remove(os.path.join(copy, "layer_three", "public.json"))
    if tamper != "missing":
        with open(path, "w") as f:
            json.dump(vals, f)
    rec = RR.check_against_recorded(copy, GOLDEN)
    assert not rec["ok"]
    assert rec["merkle_root"] and rec["batch_0_public"]
    if tamper == "batch_1":
        assert not rec["batch_1_public"] and not rec["balance_sum"]
    else:
        assert not rec["layer_three_public"] and rec["balance_sum"]


@pytest.mark.parametrize("root", ["recursive_run2", "recursive_run", "recursive_run2/x/y",
                                  "recursive_run_new"])
def test_runner_refuses_the_recorded_runs(tmp_path, root):
    target = os.path.join(REPO, "build", root)
    before = sorted(os.listdir(os.path.join(REPO, "build")))
    with pytest.raises(ValueError):
        RR.main([target, "2", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(REPO, "build"))) == before
    RR.refuse_recorded(os.path.join(REPO, "build", "torch_recursive", "run2"))
    RR.refuse_recorded(str(tmp_path))
