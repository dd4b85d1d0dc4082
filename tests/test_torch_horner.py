"""Horner over windows and the heavy-value sums of zkpoa_tpu_torch's MSM
(ops/msm.py: `horner_plain`, `fold_plain`, `tree_sum_many`, `msm_many`),
the plain versions of the kernels msm_horner and point_fold, on the CPU at
toy sizes.

Window totals and table points are host multiples k * G
(zkpoa_tpu.fields.bn254, the JAX package's host arithmetic) from numpy
seeds, given to the port in Jacobian form with random z. Horner sums are
checked against (sum_w k_w 2^(offset_w) mod r) G, tree sums against host
sums of the segment's points, whole MSMs with heavy values against the JAX
package's `msm_tpu_heavy_split` and `_tree_sum_subset`. Every comparison is
of decoded affine points, tolerance zero."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu.fields import bn254
from zkpoa_tpu.ops import msm_pallas as M2
from zkpoa_tpu.ops.curve_jax import BN254_G1 as JG1
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops.curve import BN254_G1
from zkpoa_tpu_torch.ops.fp2 import BN254_G2

torch.set_num_threads(1)

P, R = bn254.P, bn254.R
GROUPS = {
    "g1": (BN254_G1, JG1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, bn254.g1_neg),
    "g2": (BN254_G2, JG2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, bn254.g2_neg),
}


class _Table:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def _jacobian(curve, pts, rng):
    """Host affine points (None = infinity) -> Jacobian Montgomery tensors
    (x l^2, y l^3, l) with a random l per point; infinity as (l^2, l^3, 0)."""
    g2 = curve.group == 2
    mul = bn254.fp2_mul if g2 else (lambda a, b: a * b % P)
    xs, ys, zs = [], [], []
    for pt in pts:
        lam = int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
        lam = (lam, lam // 7) if g2 else lam
        l2 = mul(lam, lam)
        l3 = mul(l2, lam)
        inf = pt is None
        xs.append(l2 if inf else mul(pt[0], l2))
        ys.append(l3 if inf else mul(pt[1], l3))
        zs.append(((0, 0) if g2 else 0) if inf else lam)
    return tuple(curve.encode_coords(v, "cpu") for v in (xs, ys, zs))


def _horner_case(c, m, seed):
    """Window multiples k [m][nw], and the expected sums' multiples. MSM 0
    has an infinity top window and T_w == res at one window; the last MSM
    T_w == -res at another (so res becomes all-zero and restarts); with
    m = 4, MSM 2 is infinity in every window."""
    wins = M.windows(c)
    nw = len(wins)
    rng = np.random.default_rng(seed)
    ks = [[int(x) for x in rng.integers(1, 2**62, size=nw)] for _ in range(m)]
    ks[0][nw - 1] = 0
    ks[0][nw // 2] = 0
    if m == 4:
        ks[2] = [0] * nw
    special = {(0, nw - 4): 1, (m - 1, nw - 7): -1, (m - 1, 2): 1}
    want = []
    for i in range(m):
        acc = ks[i][nw - 1]
        for w in range(nw - 2, -1, -1):
            acc = acc * (1 << wins[w][1]) % R
            if (i, w) in special:  # T_w = +-res at this add
                ks[i][w] = special[(i, w)] * acc % R
            acc = (acc + ks[i][w]) % R
        want.append(acc)
        assert acc == sum(k << off for k, (off, _w, _s) in zip(ks[i], wins)) % R
    return ks, want


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("c", [5, 8, 11, 13])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_horner_plain_equals_host_sum(group, c, m):
    curve, _j, gen, _add, mul, _neg = GROUPS[group]
    ks, want = _horner_case(c, m, 100 + c)
    nw = len(ks[0])
    pts = [mul(gen, k) if k else None for row in ks for k in row]
    tot = _jacobian(curve, pts, np.random.default_rng(c))
    tot = tuple(t.reshape((m, nw) + curve.coord_shape) for t in tot)
    got = curve.decode_jac(M.horner_plain(curve, tot, c))
    assert got == [mul(gen, k) if k else None for k in want]
    assert curve.decode_jac(M.horner(curve, tot, c)) == got  # CPU tensors: the plain version


def _segment_case(group, seed):
    """Two tables and four segments (table, idx, offset) with absent rows,
    P == Q and P == -Q in the mixed-add rounds and in the fold's first
    level (lanes 0/2/8 one point, 1 and 3/9 a point and its negation)."""
    curve, _j, gen, add, mul, neg = GROUPS[group]
    rng = np.random.default_rng(seed)
    pts = [mul(gen, int(k)) for k in rng.integers(1, 2**40, size=30)]
    pts[7] = neg(pts[6])
    pts[11] = None  # an absent row
    t1 = _Table(*curve.encode_affine(pts, "cpu"))
    pts2 = pts[::-1]
    t2 = _Table(*curve.encode_affine(pts2, "cpu"))
    # segment 0, table 1: 37 entries (3 rounds of W = 16): lane 0 meets row 5
    # in rounds 0 and 1 (P == Q), lane 1 rows 6 then 7 (P == -Q), then row 9;
    # scalar 40 is past the table, 11 absent
    idx0 = [int(i) for i in rng.integers(0, 30, size=37)]
    idx0[0], idx0[16], idx0[1], idx0[17], idx0[33] = 5, 5, 6, 7, 9
    idx0[4], idx0[20] = 40, 11
    # segment 1, table 2 at offset 3: fold pairs (0, 2), (0, 8) meet one point,
    # (1, 3) and (1, 9) a point and its negation
    rows1 = [4, 23, 4, 22, 12, 13, 14, 15, 4, 22, 0, 1]  # pts2[22] = pts[7] = -pts[6] = -pts2[23]
    idx1 = [r + 3 for r in rows1] + [1]  # scalar 1 meets row -2: absent
    idx2 = [11, 11 + 30]  # only absent rows
    segs = [(t1, idx0, 0), (t2, idx1, 3), (t1, idx2, 0), (t2, [], 0)]

    def host_sum(table_pts, idx, off):
        acc = None
        for i in idx:
            r = i - off
            if 0 <= r < len(table_pts) and table_pts[r] is not None:
                acc = add(acc, table_pts[r])
        return acc

    want = [host_sum(pts, idx0, 0), host_sum(pts2, idx1, 3), None, None]
    segments = [(t, torch.tensor(i, dtype=torch.int64), off) for t, i, off in segs]
    return curve, segments, want


@pytest.mark.parametrize("chunk", [None, 4, 2])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_tree_sum_many_equals_host_sums(group, chunk):
    curve, segments, want = _segment_case(group, 21)
    sums = M.tree_sum_many(curve, segments, block=16, chunk=chunk)
    assert curve.decode_jac(sums) == want
    # one segment alone, and the segments in another order, give the same sums
    assert curve.decode_jac(M.tree_sum_many(curve, segments[1:2], block=16, chunk=chunk)) == want[1:2]
    perm = [3, 0, 2, 1]
    got = M.tree_sum_many(curve, [segments[k] for k in perm], block=16, chunk=chunk)
    assert curve.decode_jac(got) == [want[k] for k in perm]


@pytest.mark.parametrize("width,chunk", [(1, 4), (2, 2), (64, 8), (64, 64), (32, 4)])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fold_plain_equals_host_sums(group, width, chunk):
    curve, _j, gen, add, mul, neg = GROUPS[group]
    rng = np.random.default_rng(width + chunk)
    n_seg = 3
    pts = [mul(gen, int(k)) for k in rng.integers(1, 2**40, size=n_seg * width)]
    if width >= 4:
        pts[2] = pts[0]  # lanes (0, 2): P == Q in a level
        pts[width + 1] = neg(pts[width + 1 + width // 2])  # P == -Q in the first level
        pts[2 * width : 3 * width] = [None] * width  # a segment at infinity
    lanes = _jacobian(curve, pts, rng)
    got = curve.decode_jac(M.fold_plain(curve, lanes, width, chunk))
    want = []
    for s in range(n_seg):
        acc = None
        for p in pts[s * width : (s + 1) * width]:
            acc = add(acc, p)
        want.append(acc)
    assert got == want
    assert curve.decode_jac(M.fold(curve, lanes, width, chunk)) == got


def test_fold_chunks_and_refusals():
    assert M.fold_chunks(65536, M.FOLD_CHUNK[1]) == [512, 128]
    assert M.fold_chunks(65536, M.FOLD_CHUNK[2]) == [256, 256]
    assert M.fold_chunks(8, 512) == [8] and M.fold_chunks(1, 512) == []
    for width, chunk in ((12, 4), (0, 4), (16, 3), (16, 1)):
        with pytest.raises(ValueError):
            M.fold_chunks(width, chunk)


def _sc(scalars):
    return torch.from_numpy(host.scalars_to_limbs_fast(scalars))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_many_heavy_sums_equal_jax(group):
    """msm_many with heavy values 1 and 5 over two tables (one at a prefix
    pad, with absent rows) against the host MSMs; each heavy segment's sum
    against the JAX package's `_tree_sum_subset` (G2: the unpadded table's,
    its tree sums take seconds each on the CPU), and the unpadded G1 MSM
    against `msm_tpu_heavy_split`."""
    curve, jops, gen, add, mul, _neg = GROUPS[group]
    n, pad = 560, 40
    rng = np.random.default_rng(31)
    base = [mul(gen, int(k)) for k in rng.integers(1, 2**40, size=40)]
    pts = [base[i % 40] for i in range(n)]
    rng2 = np.random.default_rng(32)
    scalars = [int.from_bytes(rng2.bytes(32), "big") % R for _ in range(n)]
    scalars[0:300:2] = [1] * 150
    scalars[1:300:2] = [5] * 150
    scalars[300:420] = [1] * 120
    scalars[420:530] = [5] * 110
    plan = M.plan_msm(_sc(scalars), c=5)
    assert sorted(v for v, _ in plan.heavy) == [1, 5]
    table = _Table(*curve.encode_affine(pts, "cpu"))
    sub_pts = [None if i % 9 == 0 else p for i, p in enumerate(pts[pad:])]
    sub = _Table(*curve.encode_affine(sub_pts, "cpu"))

    def host_msm(table_pts, scal):
        acc = None
        for p, s in zip(table_pts, scal):
            if p is not None and s:
                acc = add(acc, mul(p, s))
        return acc

    got = M.msm_many(curve, [(table, plan, 0), (sub, plan, pad)])
    assert got == [host_msm(pts, scalars), host_msm(sub_pts, scalars[pad:])]

    segs = [(table, sel, 0) for _v, sel in plan.heavy] + [(sub, sel, pad) for _v, sel in plan.heavy]
    sums = curve.decode_jac(M.tree_sum_many(curve, segs))
    tables = [(_Table(*jops.encode_affine(pts)), pts, 0)]
    if group == "g1":
        tables.append((_Table(*jops.encode_affine(sub_pts)), sub_pts, pad))
    jax_sums = []
    for jtab, tab_pts, off in tables:
        for _v, sel in plan.heavy:
            rows = sel.numpy() - off
            rows = [r for r in rows if 0 <= r < len(tab_pts) and tab_pts[r] is not None]
            jax_sums.append(M2._tree_sum_subset(jops, jtab.xs, jtab.ys, np.array(rows, np.int64)))
    assert sums[: len(jax_sums)] == jax_sums
    if group == "g1":
        jax_msm = M2.msm_tpu_heavy_split(jops, tables[0][0], M2.scalars_to_limbs_fast(scalars),
                                         add, mul, c=5)
        assert jax_msm == got[0]
