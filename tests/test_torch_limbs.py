"""zkpoa_tpu_torch field arithmetic (ops/limbs.py) against zkpoa_tpu.ops.limbs.

Same inputs, made with numpy from a seed, go through both packages on the
CPU; the port runs the plain versions of its B1 kernels. Tolerance: exact
equality of decoded integers (all of it is integer arithmetic)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from zkpoa_tpu.ops import limbs as JL
from zkpoa_tpu_torch.convert import limbs16_to_32
from zkpoa_tpu_torch.ops import limbs as L

torch.set_num_threads(1)

SPECS = {"fq": (L.BN254_FQ, JL.BN254_FQ), "fr": (L.BN254_FR, JL.BN254_FR)}


def _values(p: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, 2, p - 2]
    vals += [int.from_bytes(rng.bytes(32), "big") % p for _ in range(n)]
    return vals


@pytest.mark.parametrize("which", ["fq", "fr"])
def test_field_ops_match_jax(which):
    spec, jspec = SPECS[which]
    p = spec.modulus
    xs = _values(p, 59, 1)
    ys = list(reversed(_values(p, 59, 2)))
    a, b = spec.encode(xs, "cpu"), spec.encode(ys, "cpu")
    ja, jb = jspec.encode(xs), jspec.encode(ys)
    # the same Montgomery integers in both layouts (R = 2^256 in both)
    assert (limbs16_to_32(np.asarray(ja)) == a.numpy()).all()
    assert spec.decode(a) == [x % p for x in xs]
    for op, jop in ((L.mont_mul, JL.mont_mul), (L.add_mod, JL.add_mod),
                    (L.sub_mod, JL.sub_mod)):
        got = spec.decode(op(spec, a, b))
        assert got == [int(v) for v in jspec.decode(jop(jspec, ja, jb))]
    assert spec.decode(L.mont_mul(spec, a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert spec.decode(L.neg_mod(spec, a)) == [int(v) for v in jspec.decode(JL.neg_mod(jspec, ja))]
    assert spec.decode(L.mont_sqr(spec, a)) == [x * x % p for x in xs]


@pytest.mark.parametrize("which", ["fq", "fr"])
def test_batched_inverse_matches_jax(which):
    spec, jspec = SPECS[which]
    xs = _values(spec.modulus, 11, 3)
    got = spec.decode(L.mont_inv(spec, spec.encode(xs, "cpu")))
    want = [int(v) for v in jspec.decode(JL.mont_inv(jspec, jspec.encode(xs)))]
    assert got == want == [pow(x, -1, spec.modulus) if x else 0 for x in xs]


def test_mont_mul_takes_unreduced_operand():
    """One operand may be any 256-bit value (the SpMV reduction relies on it)."""
    spec = L.BN254_FR
    big = torch.full((1, 8), -1, dtype=torch.int32)  # 2^256 - 1
    r2 = spec.limbs_of(spec.r2, "cpu")
    assert spec.from_limbs(spec.from_mont(L.mont_mul(spec, big, r2))) == [(2**256 - 1) % spec.modulus]


def test_to_from_mont_roundtrip_and_selects():
    spec, jspec = SPECS["fq"]
    xs = _values(spec.modulus, 7, 4)
    plain = torch.from_numpy(spec.to_limbs(xs))
    mont = spec.to_mont(plain)
    assert (limbs16_to_32(np.asarray(jspec.to_mont(jnp.asarray(jspec.to_limbs(xs))))) == mont.numpy()).all()
    assert torch.equal(spec.from_mont(mont), plain)
    zero = torch.zeros_like(mont)
    assert L.is_zero(zero).all() and not L.is_zero(mont[1:3]).any()
    cond = torch.tensor([i % 2 == 0 for i in range(len(xs))])
    sel = L.select(cond, mont, zero)
    assert spec.decode(sel) == [x if i % 2 == 0 else 0 for i, x in enumerate(xs)]
    assert L.eq(mont, mont).all()
