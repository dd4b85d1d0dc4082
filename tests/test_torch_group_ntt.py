"""The group NTT of the ceremony path (`ops/group_ntt.py`
`lagrange_points`, through `prover/ptau.py` `lagrange_g1` /
`_lagrange_g2`) on the CPU, where its kernels run as their plain versions:
the Lagrange points of a dev ceremony at m in {2, 4, 8}, G1 and G2, equal
the host L_i(tau) G, and `lagrange_g1` at m = 4 and 8 equals the JAX
package's (the port's stages run K2's signed-window ladder on twiddle
digits recoded once a domain, the JAX package's a binary ladder; several
sources in one call, as `setup_from_ptau` runs them, are held by
the ceremony keys' parity in tests/test_torch_ptau.py). Tolerance: exact
(decoded points)."""

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.fields.bn254 import R
from zkpoa_tpu_torch.ops.curve import BN254_G1
from zkpoa_tpu_torch.ops.fp2 import BN254_G2
from zkpoa_tpu_torch.prover import ptau as P

torch.set_num_threads(1)

SEED = "test-ceremony"
POWER = 3


@pytest.fixture(scope="module")
def ceremony(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ptau") / "dev.ptau")
    P.write_dev_ptau(path, POWER, seed=SEED, device="cpu")
    return path, P.read_ptau(path, "cpu")


def _lag(m, x):
    """L_i(x) for i < m over the size-m domain."""
    w = host.domain_root(m.bit_length() - 1)
    out = []
    for i in range(m):
        wi = pow(w, i, R)
        out.append(wi * (pow(x, m, R) - 1) % R * pow(m * (x - wi) % R, -1, R) % R)
    return out


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lagrange_points_equal_host_lagrange_at_tau(ceremony, group, m):
    path, pt = ceremony
    lag = _lag(m, P._hash_to_fr(SEED, "tau"))
    if group == "g1":
        got = BN254_G1.decode_jac(P.lagrange_g1(pt["tau_g1"], m))
        want = [bn254.g1_mul(bn254.G1_GEN, x) for x in lag]
        if m in (4, 8):
            from zkpoa_tpu.prover import ptau as JP

            assert got == JP.lagrange_g1(JP.read_ptau(path)["tau_g1"], m)
    else:
        got = BN254_G2.decode_jac(P._lagrange_g2(pt["tau_g2"], m))
        want = [bn254.g2_mul(bn254.G2_GEN, x) for x in lag]
    assert got == want

