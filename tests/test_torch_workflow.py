"""The port's three-layer workflow (accounting mode) on the CPU.

`zkpoa_tpu_torch.pipeline.workflow.run_workflow` on 2 fixture signatures
(`zkpoa_tpu_torch.pipeline.fixtures`) in 2 batches at tree height 3: the Merkle
root, the balance sum and the layer-three public values must equal what
`zkpoa_tpu`'s host modules compute (host Poseidon, signature parsing,
Pedersen commitment), and every proof must verify under `zkpoa_tpu`'s host
verifier. A second run against the same key cache (`-z`), resuming the
finished batches (`-r`), must load the layer-three key instead of running
setup and give the same layer-three proof, and its result must name the
batch layers it loaded and the key it took from the cache (the first run's
names none); the cached layer-two key must load with the verifying key the
first run wrote. Exact comparisons.
(The plain CPU versions make each setup and proof take tens of seconds, so
the second run resumes rather than proving every layer again.)"""

import json
import os

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)

from zkpoa_tpu.fields import curve25519 as JC
from zkpoa_tpu.ops import poseidon as jax_poseidon_host
from zkpoa_tpu_torch.pipeline import fixtures
from zkpoa_tpu.pipeline.sigs import parse_signatures_file
from zkpoa_tpu.prover import groth16 as jax_groth16
from zkpoa_tpu.utils.serde import to_limbs_85x3
from zkpoa_tpu_torch.pipeline import workflow
from zkpoa_tpu_torch.prover import cache

torch.set_num_threads(1)

BLIND = 0xB11DD1E5
HEIGHT = 3


def _host_root(addrs, bals, height):
    level = [jax_poseidon_host.poseidon2(a, b) for a, b in zip(addrs, bals)]
    level += [0] * ((1 << (height - 1)) - len(level))
    while len(level) > 1:
        level = [jax_poseidon_host.poseidon2(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]


def _proof_files(build_dir):
    dirs = [os.path.join(build_dir, d) for d in ("batch_0", "batch_1", "layer_three")]
    out = []
    for d in dirs:
        vkey = [f for f in os.listdir(d) if f.endswith("_vkey.json")][0]
        out.append((os.path.join(d, vkey), os.path.join(d, "proof.json"),
                    os.path.join(d, "public.json")))
    return out


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wf")
    sigs, anon = str(d / "sigs.json"), str(d / "anon.csv")
    fixtures.write_fixtures(2, sigs, anon, extra=2)
    return d, sigs, anon


def test_accounting_workflow_matches_host_modules_and_reuses_cached_key(
        fixture_files, monkeypatch):
    d, sigs, anon = fixture_files
    zkeys = str(d / "zkeys")
    res = workflow.run_workflow(sigs, anon, BLIND, build_root=str(d / "run1"),
                                ideal_batch_size=1, mode="accounting", zkey_cache=zkeys,
                                tree_height=HEIGHT, device="cpu")

    addrs, bals = workflow.load_anon_set(anon)
    atts = parse_signatures_file(sigs)
    root = _host_root(addrs, bals, HEIGHT)
    balance_sum = sum(a.balance for a in atts)
    com = JC.pedersen_commitment(balance_sum, BLIND)
    assert (res.num_batches, res.merkle_height) == (2, HEIGHT)
    assert res.merkle_root == root
    assert res.resumed == [] and res.cached_keys == []
    assert res.balance_sum == balance_sum
    assert res.layer_three_public == [r for ci in range(4) for r in to_limbs_85x3(com[ci])] + [root]
    files = _proof_files(res.build_dir)
    for vkey, proof, public in files:
        assert jax_groth16.verify_files(vkey, proof, public), proof

    calls = []
    monkeypatch.setattr(cache, "setup_device",
                        lambda *a, **k: calls.append(1) or pytest.fail("setup ran"))
    l3_proof = files[-1][1]
    with open(l3_proof) as f:
        first = f.read()
    os.remove(l3_proof)
    res2 = workflow.run_workflow(sigs, anon, BLIND, build_root=str(d / "run1"),
                                 ideal_batch_size=1, mode="accounting", zkey_cache=zkeys,
                                 tree_height=HEIGHT, resume=True, device="cpu")
    assert not calls
    assert res2.resumed == ["layer_two batch 0", "layer_two batch 1"]
    assert res2.cached_keys == ["layer_three_sum_2_batches"]
    assert res2.layer_three_public == res.layer_three_public
    with open(l3_proof) as f:
        assert f.read() == first
    l2_key = [f for f in os.listdir(zkeys) if f.startswith("layer_two_accounting_")]
    assert len(l2_key) == 1
    pk2 = cache.load_key(os.path.join(zkeys, l2_key[0]), "cpu")
    with open(files[0][0]) as f:
        assert pk2.vk_json == json.load(f)
