"""Pippenger multi-scalar multiplication for BN254 G1 and G2.

Port of the prover's MSM path in `zkpoa_tpu/ops/msm_pallas.py`:
`plan_witness_msms` / `WitnessMsmPlan` (:2015-2076), `msm_shared`'s
`prefix_pad` (:2177, a job's pad in `msm_many`), the h-query MSM
(`msm_tpu` :1855), the heavy-value split with `_tree_sum_subset` /
`_lane_fold` (:1947, :1928), Horner over windows (:501) and `auto_c`
(:2342).

The schedule is signed c-bit windows with 2^(c-1) buckets each:
  * recode: each scalar becomes nw = ceil(254 / c) digits with
    |d| <= 2^(c-1); bucket j of a window holds |d| = j + 1, and a negative
    digit adds -P. The top windows are (c-1)-bit unsigned ones so that the
    windows cover exactly 254 bits and load all buckets evenly (`windows`);
  * plan: per window, one sort of (bucket, sign-encoded index) gives the
    order of the points and the start of each bucket's run; each run is
    cut into pieces of at most `piece` entries (the piece table);
  * accumulation (kernel B5/B6, csrc/msm_accum.cu): one thread per piece
    sums its entries with mixed adds, then a few combine levels add each
    bucket's piece sums with full adds, at most COMBINE_FAN_IN per thread
    and level;
  * reduction (kernel B7, csrc/msm_reduce.cu): per window
    T_w = sum_j (j + 1) B_j, one block per window, every window of every
    MSM with the same c in one launch (`msm_many`);
  * Horner over windows (kernel msm_horner, csrc/msm_horner.cu: the
    doublings and adds of B4/B3): one warp per MSM runs the whole chain,
    the independent products of each formula level on parallel lanes,
    every MSM of one c in one launch.
What the TPU needed for its lockstep rounds and VMEM (top-window alias
blocks, packed x|y rows, a materialized round stream, host-loop round
groups, flag-and-repair of in-bucket doublings) has no counterpart: a
thread just walks its own piece, and P == Q is a doubling inside the
kernel.

Scalar values repeated at least HEAVY_COUNT_MIN times (about half of a
circuit's wires hold bits, so the value 1 appears ~10^6 times) are split
out: their points are summed by a tree of point adds and multiplied by the
value on the host, so no bucket's run holds them. Every (table, heavy
value) segment of a group is summed at once (`tree_sum_many`): each lane
of a segment mixed-adds its run of table rows (kernel heavy_rounds,
csrc/heavy_rounds.cu: B2's adds on the row-accumulation core), one launch
a group, then the fold (kernel point_fold, csrc/point_fold.cu: B3's adds
as a block tree), at most two launches; the group's sums reach the host
in one copy with its Horner sums.

Each kernel's launcher sits beside its plain version here; CPU tensors take
the plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .. import _build
from ..utils import trace
from . import limbs as L
from .curve import Jac, jac_add, jac_add_affine, jac_double

N_BITS = 254
HEAVY_COUNT_MIN = 256  # scalar values repeated at least this often split out
TREE_BLOCK = 1 << 16  # lanes of the heavy-value tree sum
FOLD_CHUNK = {1: 512, 2: 256}  # lanes a block of the fold kernel sums, by group
FOLD_MAX_CHUNK = 512  # two lanes a thread, at most 256 threads a block
PIECE = 32  # bucket entries per piece: one thread of B5/B6 each
COMBINE_FAN_IN = 8  # sums one thread of B5/B6's combine adds, per level
REDUCE_THREADS = 256  # threads per window in B7 (fewer when nb is smaller)
ROUNDS_MAX_SEGS = 64  # segments one launch of heavy_rounds takes (csrc/heavy_rounds.cu)
ROUNDS_MAX_TABLES = 8  # distinct tables one launch of heavy_rounds reads
# pieces a round of accumulate_plain adds at once: its limb products hold
# about 6 KB a piece, so a 2^23-scalar plan's 6M pieces would need 36 GiB
PLAIN_CHUNK = 1 << 20


def auto_c(n: int) -> int:
    """Window size by problem size, carried over from the JAX package
    (`msm_pallas.py:2342`); 254 % c != 0 keeps the top digit carry-free."""
    if n < 4096:
        return 5
    if n < 65536:
        return 8
    return 11


def geometry(c: int) -> Tuple[int, int]:
    """(nw, nb): windows and buckets per window of a c-bit signed plan."""
    assert 2 <= c <= 16 and N_BITS % c != 0, "c must not divide 254"
    return (N_BITS + c - 1) // c, 1 << (c - 1)


def windows(c: int) -> List[Tuple[int, int, bool]]:
    """(bit offset, width, signed) of each window, low first. nw - u signed
    c-bit windows, then u = nw*c - 254 unsigned (c-1)-bit windows on top:
    together exactly 254 bits, and every window's digits fill all nb
    buckets evenly. (Plain c-bit windows would leave the top window 254
    mod c bits, e.g. one bit at c = 11, so half of all points would pile
    into one top bucket and one lane would walk them all.) An unsigned
    window absorbs the carry of the signed one below it (digit <= 2^(c-1)
    = nb) and produces none, so the top never carries out."""
    nw, _nb = geometry(c)
    n_unsigned = nw * c - N_BITS
    out, off = [], 0
    for w in range(nw):
        signed = w < nw - n_unsigned
        width = c if signed else c - 1
        out.append((off, width, signed))
        off += width
    assert off == N_BITS
    return out


def recode(scalars: torch.Tensor, c: int):
    """Plain-limb scalars [N, 8] (< 2^254) -> (|digit| [nw, N] int64,
    negative [nw, N] bool) with scalar = sum_w +-|d_w| 2^(offset_w) over
    the windows of `windows(c)`; every |d_w| <= 2^(c-1)."""
    nw, _nb = geometry(c)
    n = scalars.shape[0]
    u = L.u32(scalars)
    carry = torch.zeros(n, dtype=torch.int64, device=scalars.device)
    mags = torch.empty((nw, n), dtype=torch.int64, device=scalars.device)
    signs = torch.zeros((nw, n), dtype=torch.bool, device=scalars.device)
    for w, (off, width, signed) in enumerate(windows(c)):
        limb, sh = divmod(off, 32)
        word = u[:, limb] >> sh
        if sh + width > 32 and limb + 1 < u.shape[1]:
            word = word | (u[:, limb + 1] << (32 - sh))
        e = (word & ((1 << width) - 1)) + carry
        if signed:
            neg = e > (1 << (width - 1))
            mags[w] = torch.where(neg, (1 << width) - e, e)
            signs[w] = neg & (mags[w] > 0)
            carry = neg.to(torch.int64)
        else:
            mags[w] = e
            carry = torch.zeros_like(carry)
    return mags, signs


class WitnessMsmPlan:
    """One bucket plan shared by every query table MSM'd against the same
    scalars (the prover's a/b1/b2/c witness MSMs), plus the heavy values
    split out of it.

    order[w] lists sign-encoded scalar indices (i, or i + n for -P) sorted
    by bucket; bucket b of window w is order[w, starts[w, b]:starts[w, b+1]].
    heavy is a list of (value, index tensor).

    The piece table cuts every bucket's run into pieces of at most `piece`
    entries, bucket by bucket in (window, bucket) order: piece k covers the
    flat positions order.view(-1)[piece_start[k]:piece_end[k]], and the
    pieces of bucket lane l = w * nb + b are piece_ptr[l]:piece_ptr[l+1].
    `combine` holds the levels that add a bucket's piece sums
    (`combine_levels`); combine_depth is the longest chain of full adds
    through them."""

    def __init__(self, c: Optional[int], n: int, order, starts, heavy, piece: int = PIECE,
                 shape: Optional[Tuple[int, int]] = None):
        if piece <= 0:
            raise ValueError(f"piece must be positive, got {piece}")
        self.c = c
        self.n = n
        self.nw, self.nb = geometry(c) if shape is None else shape
        if self.nw * n >= 2**31:
            raise ValueError("the plan's flat positions must fit in int32")
        self.order = order
        self.starts = starts
        self.heavy = heavy
        self.piece = piece
        self.piece_start, self.piece_end, self.piece_ptr = piece_table(starts, n, piece)
        self.n_pieces = int(self.piece_start.shape[0])
        self.combine, self.combine_depth = combine_levels(self.piece_ptr, COMBINE_FAN_IN)


def piece_table(starts: torch.Tensor, n: int, piece: int):
    """(piece_start, piece_end [P], piece_ptr [nw * nb + 1]) int32 of the
    runs order[w, starts[w, b]:starts[w, b+1]] cut into pieces of at most
    `piece` entries; positions are flat, w * n + k."""
    device = starts.device
    nw = starts.shape[0]
    base = torch.arange(nw, device=device, dtype=torch.int64).unsqueeze(1) * n
    s = (starts[:, :-1].to(torch.int64) + base).reshape(-1)
    e = (starts[:, 1:].to(torch.int64) + base).reshape(-1)
    count = (e - s + piece - 1) // piece
    ptr = torch.zeros(s.shape[0] + 1, dtype=torch.int64, device=device)
    ptr[1:] = torch.cumsum(count, 0)
    trace.count("host_sync", site="plan.piece_table")
    n_pieces = int(ptr[-1])
    lane = torch.repeat_interleave(torch.arange(s.shape[0], device=device), count,
                                   output_size=n_pieces)
    ps = s[lane] + (torch.arange(n_pieces, device=device) - ptr[lane]) * piece
    pe = torch.minimum(ps + piece, e[lane])
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return i32(ps), i32(pe), i32(ptr)


def combine_levels(ptr: torch.Tensor, fan_in: int):
    """([(start, end)] per level, chain length) of the combine that adds
    each bucket's piece sums, the sums of bucket l being
    ptr[l]:ptr[l+1]. Level 0 reads the piece sums; group g of a level adds
    its input [start[g], end[g]) in order, and a bucket's groups stay
    contiguous, so a level's output is again bucket by bucket. While some
    bucket has more than fan_in sums they are cut into groups of fan_in
    (the piece table over the sums); the last level has one group per
    bucket. The chain is fan_in per cut level plus the last's longest."""
    levels, depth = [], 0
    while True:
        count = ptr[1:] - ptr[:-1]
        most = 0
        if count.numel():
            trace.count("host_sync", site="plan.combine")
            most = int(count.max())
        if most <= fan_in:
            levels.append((ptr[:-1], ptr[1:]))
            return levels, depth + most
        trace.count("host_sync", site="plan.combine")
        start, end, ptr = piece_table(ptr.unsqueeze(0), int(ptr[-1]), fan_in)
        levels.append((start, end))
        depth += fan_in


def _heavy_split(scalars: torch.Tensor):
    """(heavy [(value, indices)], mask of scalars left to the buckets)."""
    n = scalars.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=scalars.device)
    uniq, inverse, counts = torch.unique(scalars, dim=0, return_inverse=True, return_counts=True)
    trace.count("host_sync", site="plan.unique")  # its output size; the sync debug mode misses it
    heavy = []
    trace.count("host_sync", site="plan.heavy_values")  # the nonzero
    found = torch.nonzero(counts >= HEAVY_COUNT_MIN).flatten()
    if found.numel():
        trace.count("host_sync", site="plan.heavy_values")  # its copy; an empty one is free
    for u in found.tolist():
        # the nonzero, the mask's index_put and the value's copy each wait
        trace.count("host_sync", 3, site="plan.heavy_rows")
        sel = torch.nonzero(inverse == u).flatten()
        mask[sel] = False
        val = L.BN254_FR.from_limbs(uniq[u])[0]
        if val != 0:
            heavy.append((val, sel))
    return heavy, mask


def plan_msm(scalars: torch.Tensor, c: Optional[int] = None,
             split_heavy: bool = True, piece: int = PIECE) -> WitnessMsmPlan:
    """Recode + one sort per window + the piece table, for plain-limb
    scalars [N, 8] on a device (port of `plan_witness_msms`,
    `msm_pallas.py:2052`)."""
    n = scalars.shape[0]
    c = auto_c(n) if c is None else c
    nw, nb = geometry(c)
    heavy, mask = _heavy_split(scalars) if split_heavy else ([], None)
    mags, signs = recode(scalars, c)
    key = torch.where(mags > 0, mags - 1, nb)
    if mask is not None:
        key = torch.where(mask.unsqueeze(0), key, nb)
    enc = torch.arange(n, device=scalars.device, dtype=torch.int64).unsqueeze(0) + signs * n
    comp = torch.sort(key * (2 * n) + enc, dim=1).values
    order = (comp % (2 * n)).to(torch.int32).contiguous()
    win = torch.arange(nw, device=scalars.device, dtype=torch.int64).unsqueeze(1)
    trace.count("host_sync", 2, site="plan.bincount")  # bincount reads its input's min and max
    counts = torch.bincount((win * (nb + 1) + key).flatten(), minlength=nw * (nb + 1))
    counts = counts.view(nw, nb + 1)
    starts = torch.zeros((nw, nb + 1), dtype=torch.int64, device=scalars.device)
    starts[:, 1:] = torch.cumsum(counts[:, :nb], dim=1)
    return WitnessMsmPlan(c, n, order, starts.to(torch.int32).contiguous(), heavy, piece)


def bucket_plan(row: torch.Tensor, negative: torch.Tensor, bucket: torch.Tensor,
                n_buckets: int, n_rows: int, piece: int = PIECE) -> WitnessMsmPlan:
    """A plan of one window whose buckets are arbitrary ids, for
    `accumulate`: entry e adds table row row[e] (its negation where
    negative[e]) to bucket bucket[e]. The sign-encoded rows sorted by
    bucket fill the window's order; the index space n (the sign threshold)
    is at least the table's rows and the entries, and the order's tail
    past the entries is never read."""
    device = row.device
    n_entries = int(row.shape[0])
    n = max(n_rows, n_entries, 1)
    bucket, perm = torch.sort(bucket.to(torch.int64), stable=True)
    order = torch.zeros((1, n), dtype=torch.int32, device=device)
    order[0, :n_entries] = (row.to(torch.int64) + negative.to(torch.int64) * n)[perm].to(
        torch.int32)
    starts = torch.zeros((1, n_buckets + 1), dtype=torch.int64, device=device)
    if n_entries:
        trace.count("host_sync", 2, site="plan.bincount")
    starts[0, 1:] = torch.cumsum(torch.bincount(bucket, minlength=n_buckets), 0)
    return WitnessMsmPlan(None, n, order, starts.to(torch.int32).contiguous(), [], piece,
                          shape=(1, n_buckets))


# ---------------------------------------------------------------------------
# Bucket accumulation (kernel B5/B6) and its plain version
# ---------------------------------------------------------------------------


def _inf64(curve, shape, device) -> Jac:
    return tuple(t.to(torch.int64) for t in curve.infinity(shape, device))


def check_pieces(plan: WitnessMsmPlan) -> None:
    """Raise unless the plan's piece table has the shapes its own order,
    starts and piece size give (a table swapped in from another plan)."""
    lanes = plan.nw * plan.nb
    if plan.piece <= 0:
        raise ValueError(f"piece must be positive, got {plan.piece}")
    if (tuple(plan.order.shape) != (plan.nw, plan.n)
            or tuple(plan.starts.shape) != (plan.nw, plan.nb + 1)):
        raise ValueError("plan order / starts do not have the plan's geometry")
    if tuple(plan.piece_ptr.shape) != (lanes + 1,):
        raise ValueError(f"piece_ptr must be [{lanes + 1}], the plan's buckets + 1")
    shape = (plan.n_pieces,)
    if tuple(plan.piece_start.shape) != shape or tuple(plan.piece_end.shape) != shape:
        raise ValueError(f"piece_start / piece_end must be [{plan.n_pieces}]")
    if not plan.combine or plan.combine[-1][0].shape[0] != lanes:
        raise ValueError(f"the combine's last level must have one group per bucket ({lanes})")
    levels = [t for level in plan.combine for t in level]
    for t in (plan.order, plan.starts, plan.piece_start, plan.piece_end, plan.piece_ptr, *levels):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("plan tensors must be contiguous int32")


def _group_sums_plain(curve, ar, src: Jac, start, end) -> Jac:
    """out[g] = src[start[g]] + ... + src[end[g] - 1] by full adds from
    infinity, in order (one level of B5/B6's combine): round q adds the
    q-th sum of every group that has one."""
    s = start.to(torch.int64)
    count = end.to(torch.int64) - s
    acc = _inf64(curve, (s.shape[0],), src[0].device)
    for q in range(int(count.max()) if count.numel() else 0):
        lanes = torch.nonzero(count > q).flatten()
        new = jac_add(ar, tuple(t[lanes] for t in acc), tuple(t[s[lanes] + q] for t in src))
        for t, nt in zip(acc, new):
            t[lanes] = nt
    return acc


def accumulate_plain(curve, xs, ys, valid, offset: int, plan: WitnessMsmPlan) -> Jac:
    """B5/B6's schedule in plain torch: round r adds the r-th entry of every
    piece that has one (mixed adds from infinity), then each combine level
    adds its groups' sums in order (full adds from infinity); each thread's
    adds happen in the same order as in the kernels."""
    check_pieces(plan)
    device = xs.device
    ar = curve.arith(device)
    n = plan.n
    n_rows = xs.shape[0]
    xs, ys = L.u32(xs), L.u32(ys)
    flat = plan.order.reshape(-1)
    ps = plan.piece_start.to(torch.int64)
    pe = plan.piece_end.to(torch.int64)
    if plan.n_pieces and not bool(((pe - ps >= 0) & (pe - ps <= plan.piece)).all()):
        raise ValueError(f"a piece is longer than the plan's {plan.piece} entries")
    sums = _inf64(curve, (plan.n_pieces,), device)
    for r in range(plan.piece):
        active = torch.nonzero(ps + r < pe).flatten()
        if active.numel() == 0:
            break
        for lanes in active.split(PLAIN_CHUNK):
            enc = flat[ps[lanes] + r].to(torch.int64)
            neg = enc >= n
            row = torch.where(neg, enc - n, enc) - offset
            rowc = row.clamp(0, max(n_rows - 1, 0))
            ok = (row >= 0) & (row < n_rows) & valid[rowc]
            y = ys[rowc]
            y = ar.select(neg, ar.sub(ar.zeros_like(y), y), y)
            new = jac_add_affine(ar, tuple(t[lanes] for t in sums), xs[rowc], y, ok)
            for t, nt in zip(sums, new):
                t[lanes] = nt
    for start, end in plan.combine:
        sums = _group_sums_plain(curve, ar, sums, start, end)
    return tuple(L.to_i32(t) for t in sums)


def accumulate(curve, xs, ys, valid, offset: int, plan: WitnessMsmPlan) -> Jac:
    """Bucket sums [nw * nb] of the table rows (xs, ys, valid) under the
    plan; table row = scalar index - offset."""
    if not xs.is_cuda:
        return accumulate_plain(curve, xs, ys, valid, offset, plan)
    check_pieces(plan)
    cs = curve.coord_shape
    for t in (xs, ys):
        if t.dtype != torch.int32 or tuple(t.shape[1:]) != cs or not t.is_contiguous():
            raise ValueError(f"point table must be contiguous int32 [N, {cs}]")
        if t.data_ptr() % 16:
            raise ValueError("point table must be 16-byte aligned")
    if valid.dtype != torch.bool or tuple(valid.shape) != (xs.shape[0],) or not valid.is_cuda:
        raise ValueError("valid must be a CUDA bool tensor [N]")
    levels = [t for level in plan.combine for t in level]
    if not all(t.is_cuda for t in (plan.order, plan.piece_start, plan.piece_end, *levels)):
        raise ValueError("plan tensors must be on the card")
    empty = lambda m: tuple(  # noqa: E731
        torch.empty((m,) + cs, dtype=torch.int32, device=xs.device) for _ in range(3))
    sums = empty(plan.n_pieces)
    # counted once per call: the piece kernel and the combine levels are one B5/B6
    _build.launch(
        "zk_msm_accum", f"msm_accum_g{curve.group}", curve.group,
        xs.data_ptr(), ys.data_ptr(), valid.contiguous().data_ptr(), offset, xs.shape[0],
        plan.order.data_ptr(), plan.n, plan.piece_start.data_ptr(), plan.piece_end.data_ptr(),
        plan.n_pieces, plan.piece, *[t.data_ptr() for t in sums],
    )
    for start, end in plan.combine:
        out = empty(start.shape[0])
        _build.launch(
            "zk_msm_combine", None, curve.group, *[t.data_ptr() for t in sums], sums[0].shape[0],
            start.data_ptr(), end.data_ptr(), start.shape[0], *[t.data_ptr() for t in out],
        )
        sums = out
    return sums


# ---------------------------------------------------------------------------
# Weighted bucket reduction (kernel B7) and its plain version
# ---------------------------------------------------------------------------


def reduce_threads(nb: int, threads: Optional[int] = None) -> int:
    """Threads per window of B7: REDUCE_THREADS or nb if smaller, or the
    caller's; raises unless a power of two up to REDUCE_THREADS dividing nb."""
    t = min(REDUCE_THREADS, nb) if threads is None else threads
    if t <= 0 or t & (t - 1) or t > REDUCE_THREADS or nb % t:
        raise ValueError(f"threads per window must be a power of two <= {REDUCE_THREADS} "
                         f"dividing nb = {nb}, got {t}")
    return t


def reduce_plain(curve, buckets: Jac, nw: int, nb: int, threads: Optional[int] = None) -> Jac:
    """T_w = sum_j (j + 1) B_j per window in B7's order. Thread t of T takes
    the L = nb / T buckets j in [tL, tL + L) and forms, top bucket first,
    run_t = sum B_j and tot_t = sum (j - tL + 1) B_j. Then
    T_w = sum_t tot_t + L sum_{t>=1} S_t with the suffix sums
    S_t = sum_{u>=t} run_u: a Hillis-Steele scan (S_t += S_{t+d} for
    d = 1, 2, 4, ...), log2(L) doublings of each S_t, v_t = tot_t + L S_t
    (v_0 = tot_0), and a halving tree v_t += v_{t+h}."""
    t_n = reduce_threads(nb, threads)
    seg = nb // t_n
    ar = curve.arith(buckets[0].device)
    cs = curve.coord_shape
    b = tuple(L.u32(t).reshape((nw, t_n, seg) + cs) for t in buckets)
    run = _inf64(curve, (nw, t_n), buckets[0].device)
    tot = run
    for j in range(seg - 1, -1, -1):
        run = jac_add(ar, run, tuple(t[:, :, j] for t in b))
        tot = jac_add(ar, tot, run)
    s = run
    d = 1
    while d < t_n:
        new = jac_add(ar, tuple(t[:, : t_n - d] for t in s), tuple(t[:, d:] for t in s))
        s = tuple(torch.cat([a, t[:, t_n - d :]], dim=1) for a, t in zip(new, s))
        d *= 2
    for _ in range(seg.bit_length() - 1):
        s = jac_double(ar, s)
    v = jac_add(ar, tot, s)
    v = tuple(torch.cat([a[:, :1], b_[:, 1:]], dim=1) for a, b_ in zip(tot, v))
    h = t_n // 2
    while h >= 1:
        v = jac_add(ar, tuple(t[:, :h] for t in v), tuple(t[:, h : 2 * h] for t in v))
        h //= 2
    return tuple(L.to_i32(t[:, 0]) for t in v)


def reduce(curve, buckets: Jac, nw: int, nb: int, threads: Optional[int] = None) -> Jac:
    """Window totals [nw] from bucket sums [nw * nb]; nw may count the
    windows of several MSMs of the same c, reduced in one launch."""
    t_n = reduce_threads(nb, threads)
    if not buckets[0].is_cuda:
        return reduce_plain(curve, buckets, nw, nb, t_n)
    cs = curve.coord_shape
    for t in buckets:
        if t.dtype != torch.int32 or tuple(t.shape) != (nw * nb,) + cs:
            raise ValueError(f"buckets must be int32 [{nw * nb}, {cs}]")
    dev = buckets[0].device
    out = tuple(torch.empty((nw,) + cs, dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(
        "zk_msm_reduce", f"msm_reduce_g{curve.group}", curve.group,
        *[t.contiguous().data_ptr() for t in buckets], nw, nb, t_n,
        *[t.data_ptr() for t in out],
    )
    return out


# ---------------------------------------------------------------------------
# Horner over windows (kernel msm_horner: B4 + B3) and its plain version
# ---------------------------------------------------------------------------


def horner_plain(curve, totals: Jac, c: int) -> Jac:
    """sum_w 2^(offset_w) T_w for window totals [m, nw] of m MSMs at once,
    high window first: res = T_top, then per lower window width_w
    doublings and one add res + T_w by the plain formulas. Returns [m]."""
    wins = windows(c)
    nw = len(wins)
    ar = curve.arith(totals[0].device)
    tot = tuple(L.u32(t) for t in totals)
    res = tuple(t[:, nw - 1] for t in tot)
    for w in range(nw - 2, -1, -1):
        for _ in range(wins[w][1]):
            res = jac_double(ar, res)
        res = jac_add(ar, res, tuple(t[:, w] for t in tot))
    return tuple(L.to_i32(t) for t in res)


def horner(curve, totals: Jac, c: int) -> Jac:
    """sum_w 2^(offset_w) T_w of window totals [m, nw] (B7's output of m
    MSMs of window size c): one launch of msm_horner, a warp per MSM, on
    the card; `horner_plain` on the CPU. Returns [m] points."""
    if not totals[0].is_cuda:
        return horner_plain(curve, totals, c)
    nw, _nb = geometry(c)
    cs = curve.coord_shape
    m = totals[0].shape[0]
    for t in totals:
        if t.dtype != torch.int32 or tuple(t.shape) != (m, nw) + cs:
            raise ValueError(f"window totals must be int32 [m, {nw}, {cs}]")
    n_signed = sum(1 for _off, _width, signed in windows(c) if signed)
    src = [t.contiguous() for t in totals]
    out = tuple(torch.empty((m,) + cs, dtype=torch.int32, device=src[0].device) for _ in range(3))
    if m:
        _build.launch("zk_msm_horner", f"msm_horner_g{curve.group}", curve.group,
                      *[t.data_ptr() for t in src], m, nw, c, n_signed,
                      *[t.data_ptr() for t in out])
    return out


# ---------------------------------------------------------------------------
# Heavy-value tree sums: the rounds (kernel heavy_rounds: B2's mixed adds),
# then the fold (kernel point_fold: B3), and their plain versions
# ---------------------------------------------------------------------------


def fold_chunks(width: int, chunk: int) -> List[int]:
    """Chunk widths of the fold's launches for `width` lanes a segment
    (powers of two): at most `chunk` lanes a block, then the chunk sums."""
    if width < 1 or width & (width - 1) or chunk < 2 or chunk & (chunk - 1):
        raise ValueError(f"width {width} and chunk {chunk} must be powers of two, chunk >= 2")
    out = []
    while width > 1:
        out.append(min(width, chunk))
        width //= out[-1]
    return out


def fold_plain(curve, lanes: Jac, width: int, chunk: Optional[int] = None) -> Jac:
    """Sum of each segment's `width` lanes ([S * width] -> [S]) in the fold
    kernel's order: per chunk of C lanes, halving levels x_t += x_{t+h} for
    h = C/2, ..., 1 (lower lane first), then the same over the chunk sums."""
    chunk = FOLD_CHUNK[curve.group] if chunk is None else chunk
    ar = curve.arith(lanes[0].device)
    cs = curve.coord_shape
    x = tuple(L.u32(t) for t in lanes)
    for ch in fold_chunks(width, chunk):
        x = tuple(t.reshape((-1, ch) + cs) for t in x)
        while ch > 1:
            ch //= 2
            x = jac_add(ar, tuple(t[:, :ch] for t in x), tuple(t[:, ch : 2 * ch] for t in x))
        x = tuple(t[:, 0] for t in x)
    return tuple(L.to_i32(t) for t in x)


def fold(curve, lanes: Jac, width: int, chunk: Optional[int] = None) -> Jac:
    """Sums [S] of S segments of `width` lanes each ([S * width] points):
    one launch of point_fold per chunk level on the card, `fold_plain` on
    the CPU."""
    chunk = FOLD_CHUNK[curve.group] if chunk is None else chunk
    if not lanes[0].is_cuda:
        return fold_plain(curve, lanes, width, chunk)
    if chunk > FOLD_MAX_CHUNK:
        raise ValueError(f"the fold kernel sums at most {FOLD_MAX_CHUNK} lanes a block")
    cs = curve.coord_shape
    n = lanes[0].shape[0]
    levels = fold_chunks(width, chunk)
    if n % width:
        raise ValueError(f"{n} lanes are not whole segments of {width}")
    for t in lanes:
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) + cs:
            raise ValueError(f"lanes must be int32 [{n}, {cs}]")
    x = tuple(t.contiguous() for t in lanes)
    for ch in levels:
        n //= ch
        out = tuple(torch.empty((n,) + cs, dtype=torch.int32, device=x[0].device)
                    for _ in range(3))
        if n:
            _build.launch("zk_point_fold", f"point_fold_g{curve.group}", curve.group,
                          *[t.data_ptr() for t in x], n, ch, *[t.data_ptr() for t in out])
        x = out
    return x


def _rounds_counts(segments) -> List[int]:
    """Entries of each segment (table, idx, offset): 0 for an empty table."""
    return [int(idx.shape[0]) if table.xs.shape[0] else 0 for table, idx, _off in segments]


def heavy_rounds_plain(curve, segments, width: int) -> Jac:
    """Lanes [S * width] of the heavy-value rounds in plain torch (int64):
    lane l of segment s (table, idx, off) sums the table rows
    idx[l] - off, idx[width + l] - off, ... by mixed adds from infinity in
    that order, skipping rows out of the table's range or not valid. Round r
    adds entry r * width + l of every segment that has one, so each lane's
    adds are those of the kernel, in its order."""
    device = segments[0][0].xs.device
    ar = curve.arith(device)
    counts = _rounds_counts(segments)
    acc = _inf64(curve, (len(segments) * width,), device)
    for r in range(max(-(-m // width) for m in counts)):
        lanes, xq, yq, ok = [], [], [], []
        for s, ((table, idx, off), m) in enumerate(zip(segments, counts)):
            lo, hi = r * width, min(m, (r + 1) * width)
            if hi <= lo:
                continue
            rows = idx[lo:hi].to(torch.int64) - off
            present = (rows >= 0) & (rows < table.xs.shape[0])
            rows = torch.where(present, rows, 0)
            lanes.append(s * width + torch.arange(hi - lo, device=device))
            xq.append(L.u32(table.xs[rows]))
            yq.append(L.u32(table.ys[rows]))
            ok.append(present & table.valid[rows])
        lanes = torch.cat(lanes)
        new = jac_add_affine(ar, tuple(t[lanes] for t in acc), torch.cat(xq), torch.cat(yq),
                             torch.cat(ok))
        for t, nt in zip(acc, new):
            t[lanes] = nt
    return tuple(L.to_i32(t) for t in acc)


def _rounds_launches(keys: List[tuple]) -> List[Tuple[int, int]]:
    """[start, end) of consecutive segments (table keys in order) that one
    launch of heavy_rounds takes: at most ROUNDS_MAX_SEGS segments over at
    most ROUNDS_MAX_TABLES tables."""
    out, start, tabs = [], 0, set()
    for k, key in enumerate(keys):
        if k - start == ROUNDS_MAX_SEGS or (key not in tabs and len(tabs) == ROUNDS_MAX_TABLES):
            out.append((start, k))
            start, tabs = k, set()
        tabs.add(key)
    out.append((start, len(keys)))
    return out


def heavy_rounds(curve, segments, width: int) -> Jac:
    """Lanes [S * width] of the heavy-value sums: lane l of segment s sums
    rows idx[l], idx[width + l], ... of its table (`heavy_rounds_plain`).
    One launch of heavy_rounds (csrc/heavy_rounds.cu) for every segment of
    the group on the card (more only past ROUNDS_MAX_SEGS segments or
    ROUNDS_MAX_TABLES tables); the plain version for CPU tables. The
    range check and the valid lookup run in the kernel; nothing here waits
    on the device or copies to it."""
    if width < 1 or width & (width - 1) or width > 1 << 24:
        raise ValueError(f"width must be a power of two up to 2^24, got {width}")
    if not segments:
        raise ValueError("heavy_rounds takes at least one segment")
    if not segments[0][0].xs.is_cuda:
        return heavy_rounds_plain(curve, segments, width)
    cs = curve.coord_shape
    device = segments[0][0].xs.device
    n_lanes = len(segments) * width
    if n_lanes >= 1 << 31:
        raise ValueError(f"{n_lanes} lanes: heavy_rounds takes fewer than 2^31")
    keys = []
    for table, idx, off in segments:
        n = table.xs.shape[0]
        for name, t in (("xs", table.xs), ("ys", table.ys)):
            if (t.device != device or t.dtype != torch.int32 or tuple(t.shape) != (n,) + cs
                    or not t.is_contiguous()):
                raise ValueError(f"table {name} must be contiguous int32 [{n}, {cs}] on {device}")
            if n and t.data_ptr() % 16:
                raise ValueError(f"table {name} must be 16-byte aligned")
        v = table.valid
        if v.device != device or v.dtype != torch.bool or tuple(v.shape) != (n,) \
                or not v.is_contiguous():
            raise ValueError(f"table valid must be a contiguous bool [{n}] on {device}")
        if (idx.device != device or idx.dtype != torch.int64 or idx.dim() != 1
                or not idx.is_contiguous() or idx.shape[0] >= 1 << 31):
            raise ValueError(f"segment indices must be a contiguous int64 run on {device}")
        keys.append((table.xs.data_ptr(), table.ys.data_ptr(), v.data_ptr(), n))
    out = tuple(torch.empty((n_lanes,) + cs, dtype=torch.int32, device=device) for _ in range(3))
    log_w = width.bit_length() - 1
    for lo, hi in _rounds_launches(keys):
        tab_keys = list(dict.fromkeys(keys[lo:hi]))
        tab = (ctypes.c_longlong * (4 * len(tab_keys)))(*[x for k in tab_keys for x in k])
        segs = []
        for (_table, idx, off), key in zip(segments[lo:hi], keys[lo:hi]):
            segs += [idx.data_ptr(), idx.shape[0], tab_keys.index(key), int(off)]
        seg = (ctypes.c_longlong * len(segs))(*segs)
        _build.launch("zk_heavy_rounds", f"heavy_rounds_g{curve.group}", curve.group,
                      len(tab_keys), ctypes.addressof(tab), hi - lo, ctypes.addressof(seg), log_w,
                      *[t[lo * width:].data_ptr() for t in out])
    return out


def tree_sum_many(curve, segments, block: int = TREE_BLOCK, chunk: Optional[int] = None) -> Jac:
    """Exact sums [S] (Jacobian, on the device) of the table points at the
    scalar indices of each segment (table, idx, offset): rows idx - offset,
    absent rows skipped (port of `_tree_sum_subset` / `_lane_fold`, every
    segment of a group at once). Each segment gets W lanes, W the widest
    segment's power of two capped at `block` (a power of two); lane l sums
    entries l, W + l, 2 W + l, ... (`heavy_rounds`, one launch), then
    `fold` sums each segment's lanes. Takes at least one segment; nothing
    here waits on the device."""
    counts = _rounds_counts(segments)
    width = min(block, 1 << max(max(counts) - 1, 0).bit_length())
    return fold(curve, heavy_rounds(curve, segments, width), width, chunk)


# ---------------------------------------------------------------------------
# The MSM entry points
# ---------------------------------------------------------------------------


def msm_many(curve, jobs) -> List:
    """MSMs of several tables of one group, each against a plan: jobs are
    (table, plan, prefix_pad). Returns host affine points (None =
    infinity). The heavy values of every job are summed together
    (`tree_sum_many`); MSMs with the same window size share one reduction
    launch over all their windows and one Horner launch; the group's
    Horner sums and heavy sums reach the host in one copy, and the curve's
    host arithmetic combines them there. `prefix_pad` aligns a table that
    covers only a suffix of the scalars (the C-query skips the
    n_public + 1 public wires): scalar i meets table row i - prefix_pad."""
    segments, owners = [], []
    for i, (table, plan, pad) in enumerate(jobs):
        for val, sel in plan.heavy:
            segments.append((table, sel, pad))
            owners.append((i, val))
    parts = [tree_sum_many(curve, segments)] if segments else []
    by_c = {}
    for i, (table, plan, pad) in enumerate(jobs):
        buckets = accumulate(curve, table.xs, table.ys, table.valid, pad, plan)
        by_c.setdefault(plan.c, []).append((i, buckets))
    dest = []
    for c, items in by_c.items():
        nw, nb = geometry(c)
        buckets = tuple(torch.cat([b[k] for _, b in items]) for k in range(3))
        totals = reduce(curve, buckets, len(items) * nw, nb)
        totals = tuple(t.reshape((len(items), nw) + curve.coord_shape) for t in totals)
        parts.append(horner(curve, totals, c))
        dest += [i for i, _ in items]
    trace.count("host_sync", site=f"msm_decode_g{curve.group}")
    pts = curve.decode_jac(tuple(torch.cat([p[k] for p in parts]) for k in range(3)))
    out: List = [None] * len(jobs)
    with trace.span("prove.msm.host"):
        for (i, val), s in zip(owners, pts):
            if s is not None:
                if val != 1:
                    trace.count("host_mul", site=f"heavy_g{curve.group}")
                    s = curve.host_mul(s, val)
                out[i] = s if out[i] is None else curve.host_add(out[i], s)
        for i, pt in zip(dest, pts[len(owners):]):
            if pt is not None:
                out[i] = pt if out[i] is None else curve.host_add(out[i], pt)
    return out


def msm(curve, table, scalars: torch.Tensor, c: Optional[int] = None, piece: int = PIECE):
    """MSM of one table against its own scalars [N, 8], with no heavy
    split (random scalars, as in the h-query)."""
    plan = plan_msm(scalars, c, split_heavy=False, piece=piece)
    return msm_many(curve, [(table, plan, 0)])[0]
