"""zkpoa_tpu_torch point ops (plain B2-B4 for G1 and G2) against
zkpoa_tpu.ops.curve_jax / fp2_jax on every exceptional case.

Points come from exact host arithmetic (fields/bn254.py) with numpy-seeded
multiples; JAX runs its jnp formulas on the CPU. Jacobian coordinates may
differ between the packages, so results are compared as decoded affine
points (tolerance zero)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp

from zkpoa_tpu.fields import bn254
from zkpoa_tpu.ops.curve_jax import BN254_G1 as JG1
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch.ops import limbs as L
from zkpoa_tpu_torch.ops.curve import BN254_G1
from zkpoa_tpu_torch.ops.fp2 import BN254_G2

torch.set_num_threads(1)

GROUPS = {
    "g1": (BN254_G1, JG1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, bn254.g1_neg),
    "g2": (BN254_G2, JG2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, bn254.g2_neg),
}


def _cases(gen, mul, neg):
    """(P, Q) affine pairs: generic, P == Q, P == -Q, P = inf, Q = inf, both inf."""
    rng = np.random.default_rng(11)
    k = [int(x) for x in rng.integers(2, 10**9, size=4)]
    a, b, c = mul(gen, k[0]), mul(gen, k[1]), mul(gen, k[2])
    return [(a, b), (c, c), (a, neg(a)), (None, b), (c, None), (None, None), (b, a)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_ops_match_jax_and_host(group):
    port, jops, gen, add, mul, neg = GROUPS[group]
    cases = _cases(gen, mul, neg)
    ps = [p for p, _ in cases]
    qs = [q for _, q in cases]
    # halve on the host so that a Jacobian doubling lands on the case points
    half = pow(2, -1, bn254.R)
    ps_half = [None if p is None else mul(p, half) for p in ps]
    qs_half = [None if q is None else mul(q, half) for q in qs]

    def port_jac(pts):
        x, y, v = port.encode_affine(pts, "cpu")
        one = port.arith("cpu").one_like(x.to(torch.int64))
        z = torch.where(v.view((-1,) + (1,) * (x.dim() - 1)), L.to_i32(one), torch.zeros_like(x))
        return port.double((x, y, z))

    def jax_jac(pts):
        x, y, v = jops.encode_affine(pts)
        one = jnp.asarray(jops.field.one_mont_limbs)
        zc = lambda t: jnp.where(v[:, None], jnp.broadcast_to(one, t.shape), jnp.zeros_like(t))  # noqa: E731
        z = jax.tree.map(zc, x) if isinstance(x, jnp.ndarray) else (zc(x[0]), jnp.zeros_like(x[1]))
        return jops.double((x, y, z))

    p_t, q_t = port_jac(ps_half), port_jac(qs_half)
    p_j, q_j = jax_jac(ps_half), jax_jac(qs_half)
    assert port.decode_jac(p_t) == ps

    want_add = [add(p, q) for p, q in cases]
    assert port.decode_jac(port.add(p_t, q_t)) == want_add
    assert jops.decode_jac(jops.add(p_j, q_j)) == want_add

    assert port.decode_jac(port.double(p_t)) == [add(p, p) for p in ps]
    assert port.decode_jac(port.double(p_t)) == jops.decode_jac(jops.double(p_j))

    # mixed add: affine Q with a validity mask; absent Q leaves P
    xq, yq, vq = port.encode_affine(qs, "cpu")
    vq[1] = False
    jx, jy, jv = jops.encode_affine(qs)
    jv = jv.at[1].set(False)
    got = port.decode_jac(port.add_affine(p_t, xq, yq, vq))
    want = [p if i == 1 else add(p, q) for i, (p, q) in enumerate(cases)]
    assert got == want
    assert got == jops.decode_jac(jops.add_affine(p_j, jx, jy, jv))
