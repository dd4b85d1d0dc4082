"""zkpoa_tpu_torch MSM (ops/msm.py, plain versions of kernels B5-B7 with
the B2-B4 point ops) against exact host sums and zkpoa_tpu.ops.msm_pallas.

Points are host multiples k * G from a numpy seed; scalars likewise.
Results are compared as decoded affine points (tolerance zero)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from zkpoa_tpu.fields import bn254
from zkpoa_tpu.ops import msm_pallas as M2
from zkpoa_tpu.ops.curve_jax import BN254_G1 as JG1
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops.curve import BN254_G1, DeviceG1Points
from zkpoa_tpu_torch.ops.fp2 import BN254_G2, DeviceG2Points

torch.set_num_threads(1)


class _Table:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def _points(gen, add, n, seed):
    """n distinct host points k_i * gen by a running sum of random steps."""
    rng = np.random.default_rng(seed)
    steps = [int(x) for x in rng.integers(1, 50, size=n)]
    step_pts = {s: None for s in set(steps)}
    for s in step_pts:
        acc = None
        for _ in range(s):
            acc = add(acc, gen)
        step_pts[s] = acc
    pts, acc = [], None
    for s in steps:
        acc = add(acc, step_pts[s])
        pts.append(acc)
    return pts


def _host_msm(add, mul, pts, scalars):
    acc = None
    for p, s in zip(pts, scalars):
        if p is not None and s:
            acc = add(acc, mul(p, s))
    return acc


def _rand_scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]


def _sc(scalars):
    return torch.from_numpy(host.scalars_to_limbs_fast(scalars))


@pytest.mark.parametrize("c", [5, 11, 12, 13])
def test_signed_recode_reconstructs(c):
    scalars = _rand_scalars(100, 7) + [0, 1, bn254.R - 1]
    mags, signs = M.recode(_sc(scalars), c)
    nw, nb = M.geometry(c)
    wins = M.windows(c)
    assert mags.shape == (nw, len(scalars)) and int(mags.max()) <= nb
    assert sum(width for _, width, _ in wins) == 254 and not wins[-1][2]
    for i, s in enumerate(scalars):
        val = sum((-1 if signs[w, i] else 1) * int(mags[w, i]) << wins[w][0] for w in range(nw))
        assert val == s
    # every window's digits spread over the buckets: no top-window pile-up
    plan = M.plan_msm(_sc(_rand_scalars(4096, 8)), c, split_heavy=False)
    occ = plan.starts[:, 1:] - plan.starts[:, :-1]
    assert int(occ.max()) < 8 * max(4096 // nb, 1) + 16


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_host_and_jax(group):
    if group == "g1":
        port, jops, gen, add, mul = BN254_G1, JG1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul
    else:
        port, jops, gen, add, mul = BN254_G2, JG2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul
    n = 40
    pts = _points(gen, add, n, 3)
    scalars = _rand_scalars(n, 4)
    scalars[3] = 0
    scalars[6] = 1
    pts[9] = None  # absent point
    want = _host_msm(add, mul, pts, scalars)
    xs, ys, valid = port.encode_affine(pts, "cpu")
    got = M.msm(port, _Table(xs, ys, valid), _sc(scalars), c=5)
    assert got == want
    jx, jy, jv = jops.encode_affine(pts)
    jt = _Table(jx, jy, jv)
    jax_res = M2.msm_tpu_heavy_split(jops, jt, M2.scalars_to_limbs_fast(scalars), add, mul,
                                     c=5, use_tree=(group == "g2"))
    assert jax_res == want


def test_heavy_split_prefix_pad_and_in_bucket_doubling():
    """Values repeated >= HEAVY_COUNT_MIN times leave the buckets for tree
    sums; a table covering a suffix rides the plan with prefix_pad; the
    same point with the same sub-heavy scalar repeated forces P == Q inside
    a bucket (a doubling in the accumulation)."""
    n = 600
    pts = _points(bn254.G1_GEN, bn254.g1_add, n, 5)
    scalars = _rand_scalars(n, 6)
    for i in range(0, 300):
        scalars[i] = 1
    for i in range(300, 560):
        scalars[i] = 5
    for i in range(560, 570):  # 10 copies of one (point, scalar) pair
        scalars[i] = scalars[560]
        pts[i] = pts[560]
    plan = M.plan_msm(_sc(scalars), c=5)
    assert sorted(v for v, _ in plan.heavy) == [1, 5]
    xs, ys, valid = BN254_G1.encode_affine(pts, "cpu")
    table = DeviceG1Points(xs, ys, valid)
    want = _host_msm(bn254.g1_add, bn254.g1_mul, pts, scalars)
    assert M.msm_many(BN254_G1, [(table, plan, 0)])[0] == want

    pad = 250  # a table for scalars [pad:], aligned by prefix_pad
    sub = DeviceG1Points(xs[pad:], ys[pad:], valid[pad:])
    want_sub = _host_msm(bn254.g1_add, bn254.g1_mul, pts[pad:], scalars[pad:])
    assert M.msm_many(BN254_G1, [(sub, plan, pad)])[0] == want_sub


def test_msm_many_shares_horner_across_tables():
    n = 48
    pts = _points(bn254.G1_GEN, bn254.g1_add, n, 8)
    s1, s2 = _rand_scalars(n, 9), _rand_scalars(n, 10)
    xs, ys, valid = BN254_G1.encode_affine(pts, "cpu")
    table = DeviceG1Points(xs, ys, valid)
    valid2 = valid.clone()
    valid2[::3] = False
    table2 = DeviceG1Points(xs, ys, valid2)
    p1, p2 = M.plan_msm(_sc(s1), 5), M.plan_msm(_sc(s2), 5)
    got = M.msm_many(BN254_G1, [(table, p1, 0), (table2, p1, 0), (table, p2, 0)])
    pts2 = [None if i % 3 == 0 else p for i, p in enumerate(pts)]
    assert got == [_host_msm(bn254.g1_add, bn254.g1_mul, pts, s1),
                   _host_msm(bn254.g1_add, bn254.g1_mul, pts2, s1),
                   _host_msm(bn254.g1_add, bn254.g1_mul, pts, s2)]


def test_g2_table_msm_with_heavy_values():
    n = 300
    pts = _points(bn254.G2_GEN, bn254.g2_add, 20, 12) * 15
    scalars = [3] * 280 + _rand_scalars(20, 13)
    plan = M.plan_msm(_sc(scalars), c=5)
    assert [v for v, _ in plan.heavy] == [3]
    xs, ys, valid = BN254_G2.encode_affine(pts, "cpu")
    got = M.msm_many(BN254_G2, [(DeviceG2Points(xs, ys, valid), plan, 0)])[0]
    assert got == _host_msm(bn254.g2_add, bn254.g2_mul, pts, scalars)
    assert n == len(scalars)


def test_jax_limbs_convert_to_port_tables():
    """A JAX query table re-cut by convert.limbs16_to_32 is the port's table."""
    from zkpoa_tpu_torch.convert import limbs16_to_32

    pts = _points(bn254.G1_GEN, bn254.g1_add, 5, 14) + [None]
    jx, _jy, _jv = JG1.encode_affine(pts)
    xs, _ys, _v = BN254_G1.encode_affine(pts, "cpu")
    assert (limbs16_to_32(np.asarray(jx)) == xs.numpy()).all()
    assert isinstance(jnp.asarray(jx), jnp.ndarray)
