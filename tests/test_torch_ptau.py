"""The port's ceremony path (`prover/ptau.py`) against the JAX package's
(`zkpoa_tpu/prover/ptau.py`), on the CPU, where every kernel of the path
runs as its plain version:

* `write_dev_ptau(power=3)` writes the JAX package's bytes;
* `read_ptau` decodes to the JAX package's points, and `verify_ptau`
  accepts it (and refuses a ceremony whose tau G1 point is swapped);
* `setup_from_ptau`, `contribute` and `beacon` give the JAX package's
  tables and verifying key;
* a port proof under the contributed key verifies, and the old key's does
  not;
* the cache's ceremony branch hits on its second call with an equal key.

The JAX keys are made once per module. The group NTT's Lagrange points
are held in tests/test_torch_group_ntt.py. Tolerance: exact (decoded
points, bytes)."""

import os
import shutil

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.prover import groth16
from zkpoa_tpu_torch.prover import ptau as P
from zkpoa_tpu_torch.prover.cache import cached_setup
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import host_lists, table_points
from zkpoa_tpu_torch.utils import binfmt

torch.set_num_threads(1)

SEED = "test-ceremony"
POWER = 3
ENTROPY, BEACON = "contributor-1 entropy", "deadbeef"
TABLES = ("a_query", "b1_query", "c_query", "h_query", "b2_query")
HOST = ("n_vars", "n_public", "domain_size", "alpha1", "beta1", "delta1", "beta2", "delta2",
        "vk_json", "h_basis")


def _toy(frontend):
    """Two constraints: out = 3 x y + x - 7 (coefficients 1, -1, 3, -3, 7)."""
    c = frontend()
    out = c.public_output()
    x, y = c.var(5), c.var(9)
    c.bind_output(out, c.mul(x, y) * 3 + x - 7)
    return c.compile()


@pytest.fixture(scope="module")
def ceremony(tmp_path_factory):
    from zkpoa_tpu.models.r1cs import Circuit as JaxCircuit
    from zkpoa_tpu.prover import ptau as JP

    d = tmp_path_factory.mktemp("ptau")
    port_path, jax_path = str(d / "port.ptau"), str(d / "jax.ptau")
    P.write_dev_ptau(port_path, POWER, seed=SEED, device="cpu")
    JP.write_dev_ptau(jax_path, POWER, seed=SEED)
    r1cs_j, _ = _toy(JaxCircuit)
    jpk0 = JP.setup_from_ptau(r1cs_j, jax_path)
    jpk1 = JP.contribute(jpk0, ENTROPY)
    jpk2 = JP.beacon(jpk1, BEACON, iterations=4)
    r1cs, wit = _toy(Circuit)
    cache = str(d / "keys")
    hits = []
    pk0 = cached_setup(r1cs, cache, "toy", "cpu", ptau_path=port_path, hits=hits)
    assert hits == [] and len(os.listdir(cache)) == 1  # made, then saved
    pk1 = P.contribute(pk0, ENTROPY)
    pk2 = P.beacon(pk1, BEACON, iterations=4)
    return {"port": port_path, "jax": jax_path, "r1cs": r1cs, "wit": wit, "cache": cache,
            "jax_keys": (jpk0, jpk1, jpk2), "keys": (pk0, pk1, pk2), "dir": d}


def _same_as_jax(pk, jpk):
    lists = host_lists(pk)
    for name in TABLES:
        assert getattr(lists, name) == list(getattr(jpk, name)), name
    for name in HOST:
        assert getattr(pk, name) == getattr(jpk, name), name


def test_write_dev_ptau_is_byte_equal_to_jax(ceremony):
    with open(ceremony["port"], "rb") as f, open(ceremony["jax"], "rb") as g:
        assert f.read() == g.read()


def test_read_and_verify_ptau(ceremony, tmp_path):
    from zkpoa_tpu.prover import ptau as JP

    pt, jpt = P.read_ptau(ceremony["port"], "cpu"), JP.read_ptau(ceremony["jax"])
    assert pt["power"] == jpt["power"] == POWER
    for name in ("tau_g1", "tau_g2", "alpha_tau_g1", "beta_tau_g1"):
        assert table_points(pt[name]) == jpt[name], name
    assert pt["beta_g2"] == jpt["beta_g2"]
    assert P.verify_ptau(pt) and JP.verify_ptau(jpt)
    # a ceremony whose tau G1 point is tau^2 G1 is refused
    secs = binfmt._read_container(ceremony["port"], P.PTAU_MAGIC)
    g1 = secs[2][0]
    secs[2] = [g1[:64] + g1[128:192] + g1[128:]]
    bad = str(tmp_path / "bad.ptau")
    binfmt._write_container(bad, P.PTAU_MAGIC, 1, [(k, v[0]) for k, v in sorted(secs.items())])
    assert not P.verify_ptau(P.read_ptau(bad, "cpu"))


@pytest.mark.parametrize("step", ["setup_from_ptau", "contribute", "beacon"])
def test_ceremony_keys_equal_jax(ceremony, step):
    k = ("setup_from_ptau", "contribute", "beacon").index(step)
    _same_as_jax(ceremony["keys"][k], ceremony["jax_keys"][k])


def test_contributed_key_proves_and_the_old_key_does_not_verify(ceremony):
    r1cs, wit = ceremony["r1cs"], ceremony["wit"]
    pk0, _pk1, pk2 = ceremony["keys"]
    publics = wit[1 : r1cs.n_public + 1]
    vk = groth16.VerifyingKey.from_json(pk2.vk_json)
    assert pk2.delta1 != pk0.delta1
    assert groth16.verify(vk, prove(pk2, r1cs, wit, "cpu", seed="pt2"), publics)
    old = prove(pk0, r1cs, wit, "cpu", seed="pt2")
    assert groth16.verify(groth16.VerifyingKey.from_json(pk0.vk_json), old, publics)
    assert not groth16.verify(vk, old, publics)


def test_cache_hits_on_the_second_call(ceremony):
    hits = []
    again = cached_setup(ceremony["r1cs"], ceremony["cache"], "toy", "cpu",
                         ptau_path=ceremony["port"], hits=hits)
    assert hits == ["toy"]
    pk0 = ceremony["keys"][0]
    for name in TABLES:
        for k in ("xs", "ys", "valid"):
            assert torch.equal(getattr(getattr(again, name), k), getattr(getattr(pk0, name), k))
    for name in HOST:
        assert getattr(again, name) == getattr(pk0, name), name
    # the phase-2 parameters and the ceremony file are part of the key
    other = str(ceremony["dir"] / "other.ptau")
    shutil.copy(ceremony["port"], other)
    with open(other, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x01")
    from zkpoa_tpu_torch.prover.cache import _ptau_digest

    assert _ptau_digest(other) != _ptau_digest(ceremony["port"])
