"""Batch-parallel proving of the port (`zkpoa_tpu_torch/parallel/
batch_prove.py` `prove_batched`) on the CPU over 2 and 4 gloo processes
(`tests/torch_ranks.py`): 2 and 3 witnesses of the toy Poseidon circuit
(tests/test_batch_prove.py's), so that 3 witnesses leave the last block
short on 2 ranks and a rank without one on 4, and all 3 once more a
witness at a time (chunk 1: a block of two in two chunks). The key is the
JAX package's `setup_device` key carried over by
`convert.proving_key_from_jax`. Every rank's proofs must be byte-identical
(proof JSON) to the port's sequential `prove` with seeds f"bp-b{i}" (one
a rank of the 4-rank job) and to the JAX package's sequential `prove`
(run in this process while the ranks work), and verify under the host
verifier. A key that differs on one rank makes every rank refuse; the key
cache's read-only mode (the ranks above 0 of a workflow) reads a key and
never writes one."""

import json
import os

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import tests.torch_ranks as ranks
from zkpoa_tpu.models import r1cs as jax_r1cs
from zkpoa_tpu.models.gadgets import poseidon_gadget as jax_poseidon_gadget
from zkpoa_tpu.prover.prove import prove as jax_prove
from zkpoa_tpu.prover.setup import setup_device as jax_setup_device
from zkpoa_tpu_torch.convert import proving_key_from_jax
from zkpoa_tpu_torch.models import r1cs
from zkpoa_tpu_torch.models.gadgets import poseidon_gadget
from zkpoa_tpu_torch.prover import cache, groth16

torch.set_num_threads(1)

WORLDS = [2, 4]
INPUTS = [(7, 11), (13, 17), (19, 23)]
COUNTS = [2, 3]
# the sequential proves, witness -> rank of the 4-rank job: one a rank, as
# the ranks go in step from one collective to the next
SEQUENTIAL = {4: {0: 1, 1: 2, 2: 3}}


def _toy(r1cs_mod, gadget_mod, x, y):
    c = r1cs_mod.Circuit()
    out = c.public_output()
    c.bind_output(out, gadget_mod.poseidon(c, [c.var(x), c.var(y)]))
    return c.compile()


def _json(proof) -> str:
    return json.dumps(proof.to_json(), sort_keys=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's sequential proofs, the port's r1cs and witnesses,
    {world: [outputs by rank]})."""
    port = [_toy(r1cs, poseidon_gadget, x, y) for x, y in INPUTS]
    jax_side = [_toy(jax_r1cs, jax_poseidon_gadget, x, y) for x, y in INPUTS]
    wits = [w for _, w in port]
    assert wits == [w for _, w in jax_side]
    pk_jax = jax_setup_device(jax_side[0][0], seed="batchkey")
    pk = proving_key_from_jax(pk_jax, "cpu")
    procs = {}
    for world in WORLDS:
        job_dir = tmp_path_factory.mktemp(f"prove{world}")
        job = {"world": world, "run": ["prove_batched"], "pk": pk, "r1cs": port[0][0],
               "witnesses": wits, "counts": COUNTS, "sequential": SEQUENTIAL.get(world, {})}
        procs[world] = (job_dir, ranks.start(str(job_dir), job))
    jax_proofs = [jax_prove(pk_jax, jax_side[0][0], w, seed=f"bp-b{i}")
                  for i, w in enumerate(wits)]
    outs = {world: ranks.finish(str(d), p) for world, (d, p) in procs.items()}
    return jax_proofs, port[0][0], wits, pk, outs


def test_sequential_port_proofs_equal_jax_and_verify(runs):
    jax_proofs, r1cs_port, wits, pk, outs = runs
    seq = {i: p for out in outs[4] for i, p in out["prove_batched"]["sequential"].items()}
    assert sorted(seq) == list(range(len(wits)))
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    for i, w in enumerate(wits):
        assert _json(seq[i]) == _json(jax_proofs[i])
        assert groth16.verify(vk, seq[i], [w[k] for k in range(1, r1cs_port.n_public + 1)])


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("world", WORLDS)
def test_prove_batched_is_byte_identical_to_sequential(runs, world, count):
    jax_proofs, _, _, _, outs = runs
    seq = {i: p for out in outs[4] for i, p in out["prove_batched"]["sequential"].items()}
    assert len(outs[world]) == world
    for out in outs[world]:
        got = out["prove_batched"][count]
        assert [_json(p) for p in got] == [_json(seq[i]) for i in range(count)]
        assert [_json(p) for p in got] == [_json(p) for p in jax_proofs[:count]]


@pytest.mark.parametrize("world", WORLDS)
def test_prove_batched_a_witness_at_a_time(runs, world):
    jax_proofs, _, wits, _, outs = runs
    for out in outs[world]:
        got = out["prove_batched"]["chunk1"]
        assert [_json(p) for p in got] == [_json(p) for p in jax_proofs[:len(wits)]]


@pytest.mark.parametrize("world", WORLDS)
def test_prove_batched_refuses_keys_that_differ_between_ranks(runs, world):
    _, _, _, _, outs = runs
    for out in outs[world]:
        assert out["prove_batched"]["other_key"] == "the ranks hold 2 different keys"


def test_read_only_key_cache_reads_and_never_writes(runs, tmp_path, monkeypatch):
    _, r1cs_port, _, pk, _ = runs
    monkeypatch.setattr(cache, "setup_device", lambda *a, **k: pk)
    d = tmp_path / "zkeys"
    hits = []
    assert cache.cached_setup(r1cs_port, str(d), "toy", "cpu", hits=hits, save=False) is pk
    assert not d.exists() and hits == []
    cache.cached_setup(r1cs_port, str(d), "toy", "cpu", hits=hits)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("toy.") and hits == []
    got = cache.cached_setup(r1cs_port, str(d), "toy", "cpu", hits=hits, save=False)
    assert hits == ["toy"] and got is not pk and got.vk_json == pk.vk_json
    assert os.listdir(d) == files
