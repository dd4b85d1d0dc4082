"""Poseidon and the Poseidon-Merkle engine of the port against zkpoa_tpu.

`ops/poseidon_torch` (`hash2`, `sponge_batch`, `poseidon_many`) must equal
`zkpoa_tpu.ops.poseidon_jax` and the host Poseidon on the same numpy-
seeded inputs; `merkle.tree.MerkleTree` over build/recursive_run2/anon.csv
at height 5 must give the golden root of that run and the same proofs as
`zkpoa_tpu.merkle.tree`; the port's Merkle CLI writes the same files.
All on the CPU; exact comparisons."""

import json
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)

from zkpoa_tpu.merkle import tree as jax_tree
from zkpoa_tpu.ops import poseidon as jax_host
from zkpoa_tpu.ops import poseidon_jax
from zkpoa_tpu.ops.limbs import BN254_FR as JFR
from zkpoa_tpu_torch.merkle import __main__ as merkle_cli
from zkpoa_tpu_torch.merkle.tree import MerkleTree, verify_proof
from zkpoa_tpu_torch.ops import poseidon_torch
from zkpoa_tpu_torch.ops.limbs import BN254_FR
from zkpoa_tpu_torch.pipeline.workflow import load_anon_set

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN2 = os.path.join(REPO, "build", "recursive_run2")
GOLDEN = os.path.join(RUN2, "2_sigs_2_batches_5_height")


def _rand(rng, shape):
    return [[int.from_bytes(rng.bytes(32), "big") % BN254_FR.modulus for _ in range(shape[1])]
            for _ in range(shape[0])]


def test_hash2_matches_jax_and_host():
    rows = _rand(np.random.default_rng(0), (6, 2))
    rows[0] = [0, 0]
    rows[1] = [BN254_FR.modulus - 1, 1]
    left = BN254_FR.encode([r[0] for r in rows], "cpu")
    right = BN254_FR.encode([r[1] for r in rows], "cpu")
    got = BN254_FR.decode(poseidon_torch.hash2(left, right))
    jl = JFR.encode([r[0] for r in rows])
    jr = JFR.encode([r[1] for r in rows])
    assert got == [int(x) for x in JFR.decode(poseidon_jax.hash2(jl, jr))]
    assert got == [jax_host.poseidon2(a, b) for a, b in rows]
    assert poseidon_torch.poseidon_many(rows, "cpu") == got


@pytest.mark.parametrize("length", [8, 20])
def test_sponge_batch_matches_jax_and_host(length):
    rows = _rand(np.random.default_rng(length), (3, length))
    enc = BN254_FR.encode([x for r in rows for x in r], "cpu").reshape(3, length, 8)
    got = BN254_FR.decode(poseidon_torch.sponge_batch(enc))
    jenc = JFR.encode(rows)
    assert got == [int(x) for x in JFR.decode(poseidon_jax.sponge_batch(jenc))]
    assert got == [jax_host.poseidon_sponge(r) for r in rows]


def test_golden_tree_root_and_proofs_match_jax():
    addrs, bals = load_anon_set(os.path.join(RUN2, "anon.csv"))
    tree = MerkleTree.build(addrs, bals, 5, device="cpu")
    with open(os.path.join(GOLDEN, "merkle_root.json")) as f:
        assert tree.root() == int(json.load(f))
    jtree = jax_tree.MerkleTree.build(addrs, bals, 5)
    assert tree.root() == jtree.root()
    for idx in (0, 1, 7, 12, 13, 15):
        p, jp = tree.prove(idx), jtree.prove(idx)
        assert (p.leaf, p.leaf_index, p.path_elements, p.path_indices) == \
            (jp.leaf, jp.leaf_index, jp.path_elements, jp.path_indices)
        assert verify_proof(tree.root(), p)
    bad = tree.prove(1)
    bad.path_elements[2] += 1
    assert not verify_proof(tree.root(), bad)
    with pytest.raises(ValueError):
        MerkleTree.build(addrs, bals, 4, device="cpu")


def test_merkle_cli_writes_the_golden_root(tmp_path):
    rc = merkle_cli.main(["--anon-set", os.path.join(RUN2, "anon.csv"), "--height", "5",
                          "--output-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    with open(tmp_path / "merkle_root.json") as f, \
            open(os.path.join(GOLDEN, "merkle_root.json")) as g:
        assert json.load(f) == json.load(g)
