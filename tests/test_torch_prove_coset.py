"""zkpoa_tpu_torch Groth16 setup + prove against zkpoa_tpu on the toy circuit,
coset-Lagrange H basis: the port's setup_device makes JAX's key, and the
port's proof with its own key equals JAX's and verifies."""

from tests.test_torch_prove import check_proof_matches_jax, check_setup_matches_jax, toy  # noqa: F401


def test_setup_device_matches_jax_key_coset(toy):  # noqa: F811
    check_setup_matches_jax(toy, "coset")


def test_proof_matches_jax_and_verifies_coset(toy):  # noqa: F811
    check_proof_matches_jax(toy, "coset", from_jax_key=False)
