"""The plain reference: its field arithmetic, its verifier on a recorded
proof, its proofs against the program's, and its public values against
the program's own hashes of the same seeded inputs."""

import copy
import json
import os
import random

import pytest
import torch

from poa_bench import fixtures
from poa_bench.pool import statement_of
from poa_bench.reference import fr, groth16, layer_one, recursive_layer_two
from poa_bench.reference.bn254 import R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECORDED = os.path.join(ROOT, "build", "recursive_run2", "2_sigs_2_batches_5_height",
                        "layer_three")


def test_field_products_differences_and_inverses():
    rng = random.Random(7)
    xs = [rng.randrange(R) for _ in range(300)] + [0, 1, R - 1, R - 2]
    ys = [rng.randrange(R) for _ in range(300)] + [R - 1, R - 1, R - 1, 1]
    a, b = fr.to_limbs(xs), fr.to_limbs(ys)
    assert fr.from_limbs(fr.mont_mul(a, b)) == [x * y * fr.RADIX_INV % R for x, y in zip(xs, ys)]
    assert fr.from_limbs(fr.sub_mod(a, b)) == [(x - y) % R for x, y in zip(xs, ys)]
    inv = fr.from_limbs(fr.batch_inverse(fr.to_mont(xs[:256], "cpu")))
    assert [v * fr.RADIX_INV % R for v in inv] == [pow(x, -1, R) for x in xs[:256]]
    assert fr.limb_sum(a) == sum(xs) % R


def test_lagrange_values_at_tau():
    m, tau = 32, 123456789
    got = [v * fr.RADIX_INV % R for v in fr.from_limbs(fr.lagrange_at(tau, m, "cpu"))]
    w = fr.domain_root(5)
    z = (pow(tau, m, R) - 1) * pow(m, -1, R)
    assert got == [z * pow(w, j, R) * pow(tau - pow(w, j, R), -1, R) % R for j in range(m)]


@pytest.fixture(scope="module")
def recorded():
    load = lambda name: json.load(open(os.path.join(RECORDED, name)))  # noqa: E731
    return load("layer_three_vkey.json"), load("proof.json"), [int(x) for x in load("public.json")]


def test_verifier_accepts_the_recorded_proof(recorded):
    vk, proof, publics = recorded
    assert groth16.verify(vk, proof, publics)


@pytest.mark.parametrize("what", ["pi_a", "pi_c", "public"])
def test_verifier_rejects_one_element_tampered(recorded, what):
    vk, proof, publics = copy.deepcopy(recorded)
    if what == "public":
        publics[0] = (publics[0] + 1) % R
    else:
        proof[what] = [str(v) for v in groth16.bn254.g1_add(groth16._g1(proof[what]),
                                                             groth16.bn254.G1_GEN)] + ["1"]
    assert not groth16.verify(vk, proof, publics)


def test_reference_proof_is_the_programs_on_the_toy_circuit():
    from zkpoa_tpu_torch.prover.prove import prove

    import toy

    torch.set_num_threads(2)
    pool = toy.build_pool({}, {"pool": 1}, 42, "cpu")
    r, s = 1234567, 7654321
    p = prove(pool.key, pool.r1cs, pool.witnesses[0], "cpu", r=r, s=s)
    td = groth16.dev_trapdoors(pool.key_seed)
    q = groth16.qap_at_tau(statement_of(pool.r1cs), pool.witnesses, td["tau"], "cpu")[0]
    assert groth16.proof_points(groth16.proof_scalars(q, td, r, s)) == (p.pi_a, p.pi_b, p.pi_c)
    assert groth16.proof_points(groth16.proof_scalars(q, td, r + 1, s)) != \
        (p.pi_a, p.pi_b, p.pi_c)


def test_fixtures_follow_the_seed():
    a = fixtures.signatures(2, "s1")
    assert a == fixtures.signatures(2, "s1") and a != fixtures.signatures(2, "s2")
    assert [int(e["address"], 16) for e in a] == sorted(int(e["address"], 16) for e in a)
    rows = fixtures.anon_set(a, 40, "anon")
    assert len(rows) == 40 and rows == sorted(rows)
    assert {(int(e["address"], 16), int(e["balance"])) for e in a} <= set(rows)


def test_layer_one_publics_equal_the_programs_sponge():
    from zkpoa_tpu_torch.ops import poseidon as P
    from zkpoa_tpu_torch.pipeline.sigs import parse_signatures
    from zkpoa_tpu_torch.utils.serde import to_limbs_64x4

    atts = parse_signatures(fixtures.signatures(2, "seed|batch0"))
    regs = [v for a in atts for v in to_limbs_64x4(a.signature.pubkey[0])]
    assert layer_one.expected_publics({"n_sigs": 2, "sig_seed": "seed|batch0"}) == \
        [P.poseidon_sponge(regs)]


def test_layer_two_publics_equal_the_programs_tree():
    from zkpoa_tpu_torch.merkle.tree import MerkleTree

    raw = {"n_sigs": 2, "sig_seed": "s|batch0", "anon_size": 20, "anon_seed": "s|anon",
           "height": 6}
    entries = fixtures.signatures(2, raw["sig_seed"])
    rows = fixtures.anon_set(entries, 20, raw["anon_seed"])
    tree = MerkleTree.build([a for a, _ in rows], [b for _, b in rows], 6, device="cpu")
    balance = sum(int(e["balance"]) for e in entries)
    assert recursive_layer_two.expected_publics(raw) == [balance, tree.root()]
