"""Fixed-base multiplication (kernel B8's plain version) against zkpoa_tpu.

`zkpoa_tpu_torch.ops.curve.fixed_base_mul_batch` on CPU tensors runs the
plain version `fixed_base_plain`; it must give the points of
`zkpoa_tpu.ops.curve_jax.fixed_base_mul_batch_pallas` (on the CPU that runs
the jnp `_fb_fold`, as tests/test_prove_device.py does) and of host scalar
multiplication, for G1 and G2, at n_bits 254 (setup) and 64. The scalars
include 0, 1, r - 1, r, 2^248, all 32 digits equal, and a scalar whose top
window adds P to P. Tolerance: exact equality of the decoded points.
Each curve object's own choices (generator, host arithmetic, affine
conversion and table type) are held to the JAX package's host field
arithmetic."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from zkpoa_tpu.fields import bn254 as jax_bn254
from zkpoa_tpu.ops import curve_jax
from zkpoa_tpu.ops import msm as jax_msm
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.ops.curve import (BN254_G1, DeviceG1Points, fixed_base_device_table,
                                       fixed_base_mul_batch, fixed_base_plain)
from zkpoa_tpu_torch.ops.fp2 import BN254_G2, DeviceG2Points
from zkpoa_tpu_torch.prover.setup import table_points

torch.set_num_threads(1)

R = bn254.R


def edge_scalars(n_bits: int, n: int, seed: int):
    """Edge cases below 2^n_bits, then random scalars up to n in all."""
    if n_bits == 254:
        # the top window adds (d 2^248) G to the partial sum k mod 2^248:
        # k = r gives P == -Q (d = 48), k = 98 * 2^248 - r gives P == Q (d = 49)
        edge = [0, 1, R - 1, R, 1 << 248, int("15" * 32, 16), 98 * (1 << 248) - R]
    else:
        edge = [0, 1, (1 << 64) - 1, 1 << 56, int("15" * 8, 16)]
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") % (1 << n_bits) for _ in range(n - len(edge))]
    return edge + rand


CASES = [
    ("g1", BN254_G1, curve_jax.BN254_G1, "bn254_g1", bn254.G1_GEN, bn254.g1_add, bn254.g1_mul),
    ("g2", BN254_G2, JG2, "bn254_g2", bn254.G2_GEN, bn254.g2_add, bn254.g2_mul),
]


@pytest.mark.parametrize("n_bits", [254, 64])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fixed_base_plain_matches_jax_and_host(case, n_bits):
    _, curve, jcurve, name, base, add, mul = case
    scalars = edge_scalars(n_bits, 32, seed=n_bits)
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scalars))
    got = curve.decode_jac(fixed_base_mul_batch(curve, base, sc, n_bits))

    jsc = jnp.asarray(jax_msm.scalars_to_limbs(scalars))
    want = jcurve.decode_jac(
        curve_jax.fixed_base_mul_batch_pallas(jcurve, name, base, add, jsc, n_bits))
    assert got == want
    assert got == [mul(base, k % R) for k in scalars]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fixed_base_twin_matches_jax_fixed_base_mul_batch(case):
    """`fixed_base_plain`, the twin of kernel B8 (csrc/fixed_base.cu on the
    row-accumulation core), at setup's 254 bits against the JAX package's
    `curve_jax.fixed_base_mul_batch` (w = 8) on the edge scalars 0, 1,
    r - 1, r (P == -Q in the top window), 2^248, all digits equal and
    98 * 2^248 - r (P == Q in the top window), then random ones."""
    _, curve, jcurve, name, base, add, mul = case
    scalars = edge_scalars(254, 32, seed=254)
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scalars))
    table = fixed_base_device_table(curve, base, 254, sc.device)
    got = fixed_base_plain(curve, *table, sc, 254)
    jsc = jnp.asarray(jax_msm.scalars_to_limbs(scalars))
    want = jcurve.decode_jac(curve_jax.fixed_base_mul_batch(jcurve, name, base, add, jsc, 254))
    assert curve.decode_jac(got) == want
    assert want[:4] == [None, base, mul(base, R - 1), None]


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_each_curve_owns_its_host_ops_conversion_and_table(curve):
    """The curve's generator and host add / multiply are the JAX package's
    for its group, infinity (None) included; its device conversion and its
    table type turn fixed-base multiples of the generator into the affine
    table of [k G]."""
    jg = 1 if curve is BN254_G1 else 2
    gen, add, mul = (getattr(jax_bn254, n) for n in (f"G{jg}_GEN", f"g{jg}_add", f"g{jg}_mul"))
    assert curve.generator == gen
    p, q = mul(gen, 5), mul(gen, R - 7)
    for a, b in ((p, q), (p, p), (p, mul(gen, R - 5)), (None, q), (p, None), (None, None)):
        assert curve.host_add(a, b) == add(a, b)
    for k in (0, 1, 2, R - 1, 12345678901234567890):
        assert curve.host_mul(q, k) == mul(q, k)
    assert curve.host_mul(None, 3) is None

    scalars = edge_scalars(254, 12, seed=22)
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scalars))
    tab = curve.table(*curve.to_affine(fixed_base_mul_batch(curve, curve.generator, sc, 254)))
    assert type(tab) is (DeviceG2Points if jg == 2 else DeviceG1Points)
    assert len(tab) == len(scalars) and tab.xs.shape[1:] == curve.coord_shape
    assert table_points(tab) == [mul(gen, k % R) for k in scalars]
