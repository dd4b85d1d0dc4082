"""The heavy-value rounds of zkpoa_tpu_torch's MSM (ops/msm.py
`heavy_rounds_plain`, `heavy_rounds`, `tree_sum_many`), the plain version
of the rounds kernel (csrc/heavy_rounds.cu), on the CPU at toy sizes.

Lane l of a segment sums rows idx[l], idx[W + l], ... by mixed adds in
that order, as the rounds of one mixed-add launch each did before the
kernel. `chip_smoke.rounds_b2_route` keeps that schedule as the reference
(the kernel's yardstick on the card): the lanes, and the sums after the
fold, must equal its limbs exactly. The sums
must also decode equal to the JAX package's `_tree_sum_subset` and to host
sums. Cases: rows past the table and before its offset, rows not valid, an
empty segment, a segment over an empty table, a segment of exactly W
entries, W not dividing a count, and P == Q and P == -Q inside one lane.
Table points are host multiples k * G from numpy seeds; tolerance zero."""

import numpy as np
import pytest
import torch

import chip_smoke
import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu.fields import bn254
from zkpoa_tpu.ops import msm_pallas as M2
from zkpoa_tpu.ops.curve_jax import BN254_G1 as JG1
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops.curve import BN254_G1
from zkpoa_tpu_torch.ops.fp2 import BN254_G2

torch.set_num_threads(1)

GROUPS = {
    "g1": (BN254_G1, JG1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, bn254.g1_neg),
    "g2": (BN254_G2, JG2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, bn254.g2_neg),
}
W = 16


class _Table:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def _case(group, seed):
    """Segments (table, idx, offset) over two tables of 40 points, W = 16:
    0: 37 entries (W does not divide it): lane 0 meets row 5 in rounds 0
       and 1 (P == Q), lane 1 rows 6 then 7 (P == -Q), then row 9; index 45
       is past the table, row 11 is not valid;
    1: exactly 16 entries of table 2 at offset 3, indices 0-2 before it;
    2: empty; 3: only rows that are absent; 4: over an empty table;
    5: 20 entries of table 2, lane 2 meets P == Q in rounds 0 and 1."""
    curve, _j, gen, add, mul, neg = GROUPS[group]
    rng = np.random.default_rng(seed)
    pts = [mul(gen, int(k)) for k in rng.integers(1, 2**40, size=40)]
    pts[7] = neg(pts[6])
    pts[11] = None
    pts2 = pts[::-1]
    t1 = _Table(*curve.encode_affine(pts, "cpu"))
    t2 = _Table(*curve.encode_affine(pts2, "cpu"))
    t0 = _Table(*curve.encode_affine([], "cpu"))
    idx0 = [int(i) for i in rng.integers(0, 40, size=37)]
    idx0[0], idx0[16], idx0[1], idx0[17], idx0[33] = 5, 5, 6, 7, 9
    idx0[4], idx0[20] = 45, 11
    idx1 = [0, 1, 2] + [int(i) + 3 for i in rng.integers(0, 40, size=13)]
    idx5 = [int(i) + 3 for i in rng.integers(0, 40, size=20)]
    idx5[2] = idx5[18] = 20 + 3
    segs = [(t1, idx0, 0), (t2, idx1, 3), (t1, [], 0), (t1, [11, 40, 51], 0), (t0, [0, 1], 0),
            (t2, idx5, 3)]
    assert len(idx1) == W

    def host_sum(table_pts, idx, off):
        acc = None
        for i in idx:
            r = i - off
            if 0 <= r < len(table_pts) and table_pts[r] is not None:
                acc = add(acc, table_pts[r])
        return acc

    tab_pts = {id(t1): pts, id(t2): pts2, id(t0): []}
    want = [host_sum(tab_pts[id(t)], i, off) for t, i, off in segs]
    segments = [(t, torch.tensor(i, dtype=torch.int64), off) for t, i, off in segs]
    return curve, segments, want, tab_pts


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_rounds_twin_equals_the_round_schedule_limbs(group):
    curve, segments, want, _pts = _case(group, 41)
    lanes_ref = chip_smoke.rounds_b2_route(curve, segments, W)
    sums_ref = M.fold(curve, lanes_ref, W)
    lanes = M.heavy_rounds_plain(curve, segments, W)
    for a, b in zip(lanes, lanes_ref):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(M.heavy_rounds(curve, segments, W), lanes))
    sums = M.tree_sum_many(curve, segments, block=W)
    for a, b in zip(sums, sums_ref):
        assert torch.equal(a, b)
    assert curve.decode_jac(sums) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_rounds_twin_lanes_equal_host_sums(group):
    """Each lane's sum, decoded, is the host sum of its own rows: lane 0 of
    segment 0 is 2 P5 (+ its round-2 row), lane 1 is P9 alone after
    P6 + (-P6) gave all-zero coordinates."""
    curve, segments, _want, tab_pts = _case(group, 42)
    add = GROUPS[group][3]
    lanes = curve.decode_jac(M.heavy_rounds_plain(curve, segments, W))
    for s, (table, idx, off) in enumerate(segments):
        pts = tab_pts[id(table)]
        idx = idx.tolist()
        for l in range(W):
            acc = None
            for i in idx[l::W]:
                r = i - off
                if 0 <= r < len(pts) and pts[r] is not None:
                    acc = add(acc, pts[r])
            assert lanes[s * W + l] == acc, (s, l)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_rounds_sums_equal_jax_tree_sum_subset(group):
    """tree_sum_many's sums decode equal to the JAX package's
    `_tree_sum_subset` over each segment's present rows (G2: the two
    segments with P == Q and P == -Q; its CPU tree sums take seconds)."""
    curve, segments, want, tab_pts = _case(group, 43)
    jops = GROUPS[group][1]
    sums = curve.decode_jac(M.tree_sum_many(curve, segments, block=W))
    assert sums == want
    pick = range(len(segments)) if group == "g1" else (0, 5)
    jtabs = {}
    for s in pick:
        table, idx, off = segments[s]
        pts = tab_pts[id(table)]
        rows = [r for r in (idx.numpy() - off) if 0 <= r < len(pts) and pts[r] is not None]
        if not rows:
            assert sums[s] is None
            continue
        if id(table) not in jtabs:
            jtabs[id(table)] = jops.encode_affine(pts)
        jx, jy, _v = jtabs[id(table)]
        assert sums[s] == M2._tree_sum_subset(jops, jx, jy, np.array(rows, np.int64))


def test_rounds_launch_split_and_refusals():
    """Segments split into launches of at most ROUNDS_MAX_SEGS segments over
    ROUNDS_MAX_TABLES tables; the wrapper refuses a width that is not a
    power of two and an empty segment list."""
    keys = [(k % 3,) for k in range(M.ROUNDS_MAX_SEGS + 5)]
    assert M._rounds_launches(keys) == [(0, M.ROUNDS_MAX_SEGS), (M.ROUNDS_MAX_SEGS, len(keys))]
    keys = [(k,) for k in range(M.ROUNDS_MAX_TABLES + 2)]
    assert M._rounds_launches(keys) == [(0, M.ROUNDS_MAX_TABLES), (M.ROUNDS_MAX_TABLES, len(keys))]
    assert M._rounds_launches([(0,)] * 24) == [(0, 24)]
    curve, segments, _want, _pts = _case("g1", 44)
    for width in (0, 12):
        with pytest.raises(ValueError):
            M.heavy_rounds(curve, segments, width)
    with pytest.raises(ValueError):
        M.heavy_rounds(curve, [], W)
