"""The schedule of the MSM bucket kernels B5/B6 (bucket pieces, then a
combine) and B7 (per-window thread segments, a suffix scan and a tree), in
their plain versions (zkpoa_tpu_torch/ops/msm.py) on the CPU, at toy sizes.

Bucket sums and window totals are checked against sums of host points
(zkpoa_tpu.fields.bn254, the JAX package's host arithmetic); whole MSMs
against the host MSM and the JAX package's `msm_tpu_heavy_split`. Every
comparison is of decoded affine points, tolerance zero."""

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

GROUPS = {
    "g1": (BN254_G1, JG1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, bn254.g1_neg),
    "g2": (BN254_G2, JG2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, bn254.g2_neg),
}


class _Table:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def _sc(scalars):
    return torch.from_numpy(host.scalars_to_limbs_fast(scalars))


def _scalars(n, seed, repeats=()):
    """Random scalars < r; (value, count) pairs in `repeats` placed first."""
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    i = 0
    for val, count in repeats:
        out[i : i + count] = [val] * count
        i += count
    return out


def _points(gen, mul, n, seed):
    rng = np.random.default_rng(seed)
    return [mul(gen, int(k)) for k in rng.integers(1, 2**20, size=n)]


def _plan_from_runs(c, n, runs, piece):
    """A plan whose bucket (w, b) runs are runs[(w, b)] (sign-encoded
    indices, +P for i < n, -P for i + n); other buckets are empty."""
    nw, nb = M.geometry(c)
    order = torch.zeros((nw, n), dtype=torch.int32)
    starts = torch.zeros((nw, nb + 1), dtype=torch.int32)
    for w in range(nw):
        pos = 0
        for b in range(nb):
            run = runs.get((w, b), [])
            order[w, pos : pos + len(run)] = torch.tensor(run, dtype=torch.int32)
            pos += len(run)
            starts[w, b + 1] = pos
    return M.WitnessMsmPlan(c, n, order, starts, [], piece)


@pytest.mark.parametrize("c,piece", [(5, 1), (5, 3), (6, 2), (6, 4), (6, 64)])
def test_piece_table_covers_every_entry_once(c, piece):
    n = 300
    plan = M.plan_msm(_sc(_scalars(n, 1, repeats=[(1, 260), (0, 5)])[:n]), c, piece=piece)
    nw, nb = plan.nw, plan.nb
    ps, pe, ptr = (t.to(torch.int64) for t in (plan.piece_start, plan.piece_end, plan.piece_ptr))
    lens = pe - ps
    assert bool((lens > 0).all()) and bool((lens <= piece).all())
    covered = torch.zeros(nw * n, dtype=torch.int64)
    for s, e in zip(ps.tolist(), pe.tolist()):
        covered[s:e] += 1
    want = torch.zeros(nw, n, dtype=torch.int64)
    run_lens = plan.starts[:, 1:] - plan.starts[:, :-1]
    for w in range(nw):
        want[w, : int(plan.starts[w, nb])] = 1
    assert torch.equal(covered, want.reshape(-1))
    # bucket lane l owns pieces ptr[l]:ptr[l+1], in order, back to back over its run
    base = torch.arange(nw).unsqueeze(1) * n
    s = (plan.starts[:, :-1] + base).reshape(-1)
    e = (plan.starts[:, 1:] + base).reshape(-1)
    count = ptr[1:] - ptr[:-1]
    assert torch.equal(count, (run_lens.reshape(-1) + piece - 1) // piece)
    for lane in torch.nonzero(count).flatten().tolist():
        k0, k1 = int(ptr[lane]), int(ptr[lane + 1])
        assert int(ps[k0]) == int(s[lane]) and int(pe[k1 - 1]) == int(e[lane])
        assert torch.equal(ps[k0 + 1 : k1], pe[k0 : k1 - 1])
    assert plan.n_pieces == int(count.sum())
    # the most pieces a bucket, from piece_ptr: what the combine's levels follow
    most = int(count.max())
    assert most == int((run_lens.max() + piece - 1) // piece)
    if most <= M.COMBINE_FAN_IN:
        assert len(plan.combine) == 1 and plan.combine_depth == most
    else:
        assert len(plan.combine) > 1 and plan.combine_depth > M.COMBINE_FAN_IN


@pytest.mark.parametrize("fan_in", [2, 3, 8])
def test_combine_levels_add_each_buckets_sums_once(fan_in):
    """Carried out on integers, each level's groups sum their inputs and
    the last level leaves every bucket the sum of its own piece sums."""
    counts = torch.tensor([0, 1, fan_in, fan_in + 1, 70, 3, 0, 2 * fan_in * fan_in + 5])
    ptr = torch.zeros(counts.shape[0] + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(counts, 0)
    levels, depth = M.combine_levels(ptr, fan_in)
    sums = torch.from_numpy(np.random.default_rng(fan_in).integers(1, 1000, int(ptr[-1])))
    vals = sums
    chain = torch.zeros_like(vals)  # dependent adds behind each value
    for start, end in levels:
        lens = (end - start).to(torch.int64)
        assert bool((lens >= 0).all()) and int(lens.max()) <= fan_in
        vals = torch.stack([vals[s:e].sum() for s, e in zip(start.tolist(), end.tolist())])
        chain = torch.stack([chain[s:e].max() + (e - s) if e > s else torch.tensor(0)
                             for s, e in zip(start.tolist(), end.tolist())])
    assert levels[-1][0].shape[0] == counts.shape[0]
    assert vals.tolist() == [int(t.sum()) for t in torch.split(sums, counts.tolist())]
    assert depth == int(chain.max())


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("piece", [2, 3])
def test_accumulate_plain_buckets_equal_host_sums(group, piece):
    curve, _jops, gen, add, mul, neg = GROUPS[group]
    n, pad = 40, 4  # table rows are scalar indices pad .. n - 1 (prefix_pad offset)
    pts = _points(gen, mul, n, 2)
    pts[7] = pts[6]  # a second copy of one point under another index
    table_pts = pts[pad : n - 2]  # indices n - 2 and n - 1 are past the table
    table_pts[10 - pad] = None  # an absent row
    xs, ys, valid = curve.encode_affine(table_pts, "cpu")
    a, b, c_ = 5, 6, 8
    runs = {
        (0, 0): [a] * 5,  # P == Q inside a piece and, as piece sums, across pieces
        (0, 1): [a, a + n, b],  # P == -Q inside a piece, then a fresh start
        (0, 2): [a, b, a + n, b + n],  # piece sums P and -P meet in the combine
        (0, 3): [10, 10 + n],  # only an absent row: infinity
        (0, 4): [10, c_, 10, 6, 7 + n],  # absent rows among others; 6 and -7 are P, -P
        (0, 5): [1, 2, 3, 30],  # rows 1-3 are before the table (prefix_pad): skipped
        (0, 6): [c_ + n],  # a single entry
        (0, 7): [n - 1, n - 2 + n, 12],  # rows past the table's end: skipped
        (0, 9): [11, 12, 13, 14, 15, 16, 17, 18],
        (1, 0): [6, 7, 6 + n, 7],  # 2P - P: doubling, then a P == -Q-free add
    }
    rng = np.random.default_rng(3)
    for bucket in range(8):  # random runs in window 2, some empty
        size = int(rng.integers(0, 9))
        runs[(2, bucket)] = [int(x) for x in rng.integers(0, 2 * n, size=size)]
    plan = _plan_from_runs(5, n, runs, piece)
    got = curve.decode_jac(M.accumulate(curve, xs, ys, valid, pad, plan))
    for lane, pt in enumerate(got):
        want = None
        for e in runs.get(divmod(lane, plan.nb), []):
            i = e - n if e >= n else e
            p = pts[i] if pad <= i < n - 2 and table_pts[i - pad] is not None else None
            if p is not None:
                want = add(want, neg(p) if e >= n else p)
        assert pt == want, (divmod(lane, plan.nb), pt, want)


def _host_window_total(add, mul, bs):
    acc = None
    for j, b in enumerate(bs):
        if b is not None:
            acc = add(acc, mul(b, j + 1))
    return acc


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("threads", [1, 4, 16])
def test_reduce_plain_over_several_msms_equals_host(group, threads):
    curve, _jops, gen, add, mul, neg = GROUPS[group]
    nb, n_msm, nw = 16, 3, 2  # three MSMs' windows in one call
    rng = np.random.default_rng(4 + threads)
    base = _points(gen, mul, 6, 5)
    windows = []
    for w in range(n_msm * nw):
        bs = [base[int(k)] if k < 6 else None for k in rng.integers(0, 8, size=nb)]
        if w == 0:
            bs[3] = bs[2] = base[0]  # equal neighbours
            bs[5], bs[9] = base[1], neg(base[1])  # B and -B
            bs[15] = None
        if w == 1:
            bs = [None] * nb  # a window of infinity
        if w == 2:
            bs = [base[2]] * nb
        windows.append(bs)
    flat = [b for bs in windows for b in bs]
    xs, ys, valid = curve.encode_affine(flat, "cpu")
    one = curve.encode_coords([1 if group == "g1" else (1, 0)] * len(flat), "cpu")
    zs = torch.where(valid.reshape((-1,) + (1,) * (one.dim() - 1)), one, torch.zeros_like(one))
    got = curve.decode_jac(M.reduce(curve, (xs, ys, zs), n_msm * nw, nb, threads))
    assert got == [_host_window_total(add, mul, bs) for bs in windows]


def test_reduce_and_accumulate_refuse_what_they_cannot_take():
    n = 64
    plan = M.plan_msm(_sc(_scalars(n, 7)), 5, piece=2)
    other = M.plan_msm(_sc(_scalars(n, 7)), 5, piece=4)
    with pytest.raises(ValueError):
        M.plan_msm(_sc(_scalars(n, 7)), 5, piece=0)
    xs, ys, valid = BN254_G1.encode_affine(_points(bn254.G1_GEN, bn254.g1_mul, n, 8), "cpu")
    plan.piece_start, plan.piece_end, plan.piece_ptr = (
        other.piece_start, other.piece_end, other.piece_ptr)
    with pytest.raises(ValueError):  # another plan's piece count
        M.accumulate(BN254_G1, xs, ys, valid, 0, plan)
    other.piece = 2  # the same shapes, but pieces longer than the plan's size
    with pytest.raises(ValueError):
        M.accumulate(BN254_G1, xs, ys, valid, 0, other)
    buckets = BN254_G1.infinity((plan.nw * plan.nb,), "cpu")
    for threads in (0, 3, 32, 512):  # not a power of two dividing nb = 16, or too many
        with pytest.raises(ValueError):
            M.reduce(BN254_G1, buckets, plan.nw, plan.nb, threads)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_many_with_small_pieces_equals_host_and_jax(group):
    curve, jops, gen, add, mul, _neg = GROUPS[group]
    n = 60 if group == "g1" else 30  # host G2 multiplications are slow
    pts = _points(gen, mul, n, 9)
    pts[11] = None
    s1 = _scalars(n, 10)
    s1[20:26] = [s1[19]] * 6  # one digit in every window six more times
    pts[20:26] = [pts[19]] * 6  # on the same point: P == Q across pieces
    s2 = _scalars(n, 11)
    xs, ys, valid = curve.encode_affine(pts, "cpu")
    table = _Table(xs, ys, valid)
    p1, p2 = M.plan_msm(_sc(s1), 5, piece=2), M.plan_msm(_sc(s2), 5, piece=3)
    got = M.msm_many(curve, [(table, p1, 0), (table, p2, 0)])

    def host_msm(scal):
        acc = None
        for p, s in zip(pts, scal):
            if p is not None:
                acc = add(acc, mul(p, s))
        return acc

    assert got == [host_msm(s1), host_msm(s2)]
    if group == "g2":  # the JAX G2 MSM is held to the host in test_torch_msm.py
        return
    jt = _Table(*jops.encode_affine(pts))
    assert M2.msm_tpu_heavy_split(jops, jt, M2.scalars_to_limbs_fast(s1), add, mul, c=5) == got[0]


def test_accumulate_plain_in_chunks_equals_one_chunk(monkeypatch):
    """The plain rounds add their pieces PLAIN_CHUNK at a time (which bounds
    their memory on the card at 2^23 scalars): cut into chunks of 7 pieces,
    the bucket sums equal those of one chunk limb for limb."""
    curve, _jops, gen, _add, mul, _neg = GROUPS["g1"]
    n = 120
    xs, ys, valid = curve.encode_affine(_points(gen, mul, n, 4), "cpu")
    plan = M.plan_msm(_sc(_scalars(n, 5)), 5, split_heavy=False, piece=3)
    assert plan.n_pieces > 7
    whole = M.accumulate_plain(curve, xs, ys, valid, 0, plan)
    monkeypatch.setattr(M, "PLAIN_CHUNK", 7)
    chunked = M.accumulate_plain(curve, xs, ys, valid, 0, plan)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
