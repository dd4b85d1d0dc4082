"""Pippenger multi-scalar multiplication for BN254 G1 and G2.

Port of the prover's MSM path in `zkpoa_tpu/ops/msm_pallas.py`:
`plan_witness_msms` / `WitnessMsmPlan` (:2015-2076), `msm_shared` with
`prefix_pad` (:2177), the h-query MSM (`msm_tpu` :1855), the heavy-value
split with `_tree_sum_subset` / `_lane_fold` (:1947, :1928), Horner over
windows (:501) and `auto_c` (:2342).

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
  * Horner over windows through the point kernels B3/B4.
What the TPU needed for its lockstep rounds and VMEM (top-window alias
blocks, packed x|y rows, a materialized round stream, host-loop round
groups, flag-and-repair of in-bucket doublings) has no counterpart: a
thread just walks its own piece, and P == Q is a doubling inside the
kernel.

Scalar values repeated at least HEAVY_COUNT_MIN times (about half of a
circuit's wires hold bits, so the value 1 appears ~10^6 times) are split
out: their points are summed by a tree of point adds and multiplied by the
value on the host, so no bucket's run holds them.

Each kernel's launcher sits beside its plain version here; CPU tensors take
the plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import _build
from . import limbs as L
from .curve import Jac, jac_add, jac_add_affine, jac_double

N_BITS = 254
HEAVY_COUNT_MIN = 256  # scalar values repeated at least this often split out
TREE_BLOCK = 1 << 16  # lanes of the heavy-value tree sum
PIECE = 32  # bucket entries per piece: one thread of B5/B6 each
COMBINE_FAN_IN = 8  # sums one thread of B5/B6's combine adds, per level
REDUCE_THREADS = 256  # threads per window in B7 (fewer when nb is smaller)


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
    (`combine_levels`); max_pieces is the most pieces any bucket has and
    combine_depth the longest chain of full adds through the levels."""

    def __init__(self, c: int, n: int, order, starts, heavy, piece: int = PIECE):
        if piece <= 0:
            raise ValueError(f"piece must be positive, got {piece}")
        self.c = c
        self.n = n
        self.nw, self.nb = geometry(c)
        if self.nw * n >= 2**31:
            raise ValueError("the plan's flat positions must fit in int32")
        self.order = order
        self.starts = starts
        self.heavy = heavy
        self.piece = piece
        self.piece_start, self.piece_end, self.piece_ptr = piece_table(starts, n, piece)
        self.n_pieces = int(self.piece_start.shape[0])
        counts = self.piece_ptr[1:] - self.piece_ptr[:-1]
        self.max_pieces = int(counts.max()) if counts.numel() else 0
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
        most = int(count.max()) if count.numel() else 0
        if most <= fan_in:
            levels.append((ptr[:-1], ptr[1:]))
            return levels, depth + most
        start, end, ptr = piece_table(ptr.unsqueeze(0), int(ptr[-1]), fan_in)
        levels.append((start, end))
        depth += fan_in


def _heavy_split(scalars: torch.Tensor):
    """(heavy [(value, indices)], mask of scalars left to the buckets)."""
    n = scalars.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=scalars.device)
    uniq, inverse, counts = torch.unique(scalars, dim=0, return_inverse=True, return_counts=True)
    heavy = []
    for u in torch.nonzero(counts >= HEAVY_COUNT_MIN).flatten().tolist():
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
    counts = torch.bincount((win * (nb + 1) + key).flatten(), minlength=nw * (nb + 1))
    counts = counts.view(nw, nb + 1)
    starts = torch.zeros((nw, nb + 1), dtype=torch.int64, device=scalars.device)
    starts[:, 1:] = torch.cumsum(counts[:, :nb], dim=1)
    return WitnessMsmPlan(c, n, order, starts.to(torch.int32).contiguous(), heavy, piece)


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
        lanes = torch.nonzero(ps + r < pe).flatten()
        if lanes.numel() == 0:
            break
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


def horner(curve, totals: Jac, c: int) -> Jac:
    """sum_w 2^(offset_w) T_w for window totals [m, nw] of m MSMs at once,
    high window first: res = res * 2^(width_w) + T_w, i.e. width_w
    doublings (B4) and one add (B3) per window. Returns [m] points."""
    wins = windows(c)
    nw = len(wins)
    res = tuple(t[:, nw - 1].contiguous() for t in totals)
    for w in range(nw - 2, -1, -1):
        for _ in range(wins[w][1]):
            res = curve.double(res)
        res = curve.add(res, tuple(t[:, w].contiguous() for t in totals))
    return res


# ---------------------------------------------------------------------------
# Heavy-value tree sums and the MSM entry points
# ---------------------------------------------------------------------------


def tree_sum_subset(curve, table, idx: torch.Tensor, offset: int = 0):
    """Exact sum of table points at scalar indices idx (rows idx - offset,
    absent rows skipped) by blocked mixed adds (B2) into a power-of-two
    lane array and one halving fold (B3). Returns a host affine point or
    None (port of `_tree_sum_subset` / `_lane_fold`)."""
    rows = idx.to(torch.int64) - offset
    rows = rows[(rows >= 0) & (rows < table.xs.shape[0])]
    rows = rows[table.valid[rows]]
    m = int(rows.shape[0])
    if m == 0:
        return None
    width = min(TREE_BLOCK, 1 << (m - 1).bit_length())
    pad = (-m) % width
    rows = torch.cat([rows, torch.full((pad,), -1, dtype=torch.int64, device=rows.device)])
    acc = curve.infinity((width,), rows.device)
    for off in range(0, rows.shape[0], width):
        blk = rows[off : off + width]
        safe = blk.clamp(min=0)
        acc = curve.add_affine(acc, table.xs[safe], table.ys[safe], blk >= 0)
    while width > 1:
        width //= 2
        acc = curve.add(tuple(t[:width] for t in acc), tuple(t[width:].contiguous() for t in acc))
    return curve.decode_jac(acc)[0]


def msm_many(curve, jobs, host_add, host_mul) -> List:
    """MSMs of several tables, each against a plan: jobs are (table, plan,
    prefix_pad). Returns host affine points (None = infinity). MSMs with
    the same window size share one reduction launch over all their windows
    and one Horner pass. `prefix_pad` aligns a table that covers only a
    suffix of the scalars (the C-query skips the n_public + 1 public
    wires): scalar i meets table row i - prefix_pad."""
    out: List = [None] * len(jobs)
    extra: List = [None] * len(jobs)
    by_c = {}
    for i, (table, plan, pad) in enumerate(jobs):
        for val, sel in plan.heavy:
            s = tree_sum_subset(curve, table, sel, pad)
            if s is not None:
                contrib = s if val == 1 else host_mul(s, val)
                extra[i] = contrib if extra[i] is None else host_add(extra[i], contrib)
        buckets = accumulate(curve, table.xs, table.ys, table.valid, pad, plan)
        by_c.setdefault(plan.c, []).append((i, buckets))
    for c, items in by_c.items():
        nw, nb = geometry(c)
        buckets = tuple(torch.cat([b[k] for _, b in items]) for k in range(3))
        totals = reduce(curve, buckets, len(items) * nw, nb)
        totals = tuple(t.reshape((len(items), nw) + curve.coord_shape) for t in totals)
        for (i, _), pt in zip(items, curve.decode_jac(horner(curve, totals, c))):
            out[i] = pt
    for i, e in enumerate(extra):
        if e is not None:
            out[i] = e if out[i] is None else host_add(out[i], e)
    return out


def msm_shared(curve, table, plan: WitnessMsmPlan, host_add, host_mul, prefix_pad: int = 0):
    """One table's MSM against a shared plan (port of `msm_shared`)."""
    return msm_many(curve, [(table, plan, prefix_pad)], host_add, host_mul)[0]


def msm(curve, table, scalars: torch.Tensor, host_add, host_mul, c: Optional[int] = None,
        piece: int = PIECE):
    """MSM of one table against its own scalars [N, 8], with no heavy
    split (random scalars, as in the h-query)."""
    plan = plan_msm(scalars, c, split_heavy=False, piece=piece)
    return msm_shared(curve, table, plan, host_add, host_mul)
