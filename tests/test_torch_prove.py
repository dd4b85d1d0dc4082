"""zkpoa_tpu_torch Groth16 setup + prove against zkpoa_tpu on the toy circuit
of tests/test_prove_device.py, monomial H basis (coset basis:
test_torch_prove_coset.py).

The port's setup_device must make the JAX package's key (same tables),
its proof must equal JAX's pi_a / pi_b / pi_c and verify, and a JAX key
carried over by convert.proving_key_from_jax must prove the same. Also:
the port's layer-one input from build/recursive_run/sigs.json equals JAX's,
and the port's prove path imports no JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)

from zkpoa_tpu.models.gadgets.poseidon_gadget import poseidon
from zkpoa_tpu.models.r1cs import Circuit
from zkpoa_tpu.prover import groth16
from zkpoa_tpu.prover.prove import prove as jax_prove
from zkpoa_tpu.prover.setup import setup_device as jax_setup_device
from zkpoa_tpu_torch.convert import limbs16_to_32, proving_key_from_jax
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import setup_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_circuit():
    c = Circuit()
    out = c.public_output()
    x = c.var(7)
    y = c.var(11)
    c.bind_output(out, poseidon(c, [x, y]))
    return c.compile()


@pytest.fixture(scope="module")
def toy():
    return _toy_circuit()


_KEYS = {}


def _keys(toy, basis):
    """(port key, JAX key, JAX proof) per basis, made once per module."""
    if basis not in _KEYS:
        r1cs, wit = toy
        pk_jax = jax_setup_device(r1cs, seed="devtest", h_basis=basis)
        proof_jax = jax_prove(pk_jax, r1cs, wit, seed="p1")
        pk = setup_device(r1cs, "cpu", seed="devtest", h_basis=basis)
        _KEYS[basis] = (pk, pk_jax, proof_jax)
    return _KEYS[basis]


def _same_table(port_tab, jax_tab, g2: bool):
    conv = (lambda t: np.stack([limbs16_to_32(t[0]), limbs16_to_32(t[1])], axis=-2)) if g2 \
        else limbs16_to_32
    assert (port_tab.xs.numpy() == conv(jax_tab.xs)).all()
    assert (port_tab.ys.numpy() == conv(jax_tab.ys)).all()
    assert (port_tab.valid.numpy() == np.asarray(jax_tab.valid)).all()


def check_setup_matches_jax(toy, basis):
    pk, pk_jax, _ = _keys(toy, basis)
    for name in ("a_query", "b1_query", "c_query", "h_query"):
        _same_table(getattr(pk, name), getattr(pk_jax, name), g2=False)
    _same_table(pk.b2_query, pk_jax.b2_query, g2=True)
    for name in ("n_vars", "n_public", "domain_size", "alpha1", "beta1", "delta1",
                 "beta2", "delta2", "vk_json", "h_basis"):
        assert getattr(pk, name) == getattr(pk_jax, name), name


def check_proof_matches_jax(toy, basis, from_jax_key: bool):
    """The port's proof equals JAX's and verifies; with from_jax_key the
    port proves with the JAX key carried over by proving_key_from_jax."""
    r1cs, wit = toy
    pk, pk_jax, proof_jax = _keys(toy, basis)
    if from_jax_key:
        pk = proving_key_from_jax(pk_jax, "cpu")
    proof = prove(pk, r1cs, wit, "cpu", seed="p1")
    assert proof.pi_a == proof_jax.pi_a
    assert proof.pi_b == proof_jax.pi_b
    assert proof.pi_c == proof_jax.pi_c
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    assert groth16.verify(vk, proof, [wit[w] for w in range(1, r1cs.n_public + 1)])


# The coset basis has the same two tests in test_torch_prove_coset.py (a
# file of its own so that the parallel test run spreads the two bases).


def test_setup_device_matches_jax_key(toy):
    check_setup_matches_jax(toy, "monomial")


def test_proof_matches_jax_and_verifies(toy):
    check_proof_matches_jax(toy, "monomial", from_jax_key=True)


def test_layer_one_input_matches_jax():
    from zkpoa_tpu.pipeline import sigs as jax_sigs
    from zkpoa_tpu_torch.pipeline import sigs

    path = os.path.join(REPO, "build", "recursive_run", "sigs.json")
    got = sigs.layer_one_input(sigs.parse_signatures_file(path))
    assert got == jax_sigs.layer_one_input(jax_sigs.parse_signatures_file(path))
    with open(path) as f:
        entries = json.load(f)
    bad = [dict(entries[0], address="0x" + "11" * 20)]
    with pytest.raises(ValueError):
        sigs.parse_signatures(bad)


def test_prove_path_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    code = (
        "import sys\n"
        "import zkpoa_tpu_torch.prover.prove, zkpoa_tpu_torch.prover.setup\n"
        "import zkpoa_tpu_torch.prover.__main__, zkpoa_tpu_torch.pipeline.sigs\n"
        "import zkpoa_tpu_torch.convert, zkpoa_tpu_torch.ops.msm, zkpoa_tpu_torch.ops.ntt\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd="/",
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
