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
    order of the points and the start of each bucket's run;
  * accumulation (kernel B5/B6, csrc/msm_accum.cu): one thread per
    (window, bucket) walks its run and reads its points by index;
  * reduction (kernel B7, csrc/msm_reduce.cu): per window
    T_w = sum_j (j + 1) B_j by segmented running sums;
  * Horner over windows through the point kernels B3/B4.
What the TPU needed for its lockstep rounds and VMEM (top-window alias
blocks, packed x|y rows, a materialized round stream, host-loop round
groups, flag-and-repair of in-bucket doublings) has no counterpart: a lane
just walks its own run, and P == Q is a doubling inside the kernel.

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
    heavy is a list of (value, index tensor)."""

    def __init__(self, c: int, n: int, order, starts, heavy):
        self.c = c
        self.n = n
        self.nw, self.nb = geometry(c)
        self.order = order
        self.starts = starts
        self.heavy = heavy


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
             split_heavy: bool = True) -> WitnessMsmPlan:
    """Recode + one sort per window for plain-limb scalars [N, 8] on a
    device (port of `plan_witness_msms`, `msm_pallas.py:2052`)."""
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
    return WitnessMsmPlan(c, n, order, starts.to(torch.int32).contiguous(), heavy)


# ---------------------------------------------------------------------------
# Bucket accumulation (kernel B5/B6) and its plain version
# ---------------------------------------------------------------------------


def _inf64(curve, shape, device) -> Jac:
    return tuple(t.to(torch.int64) for t in curve.infinity(shape, device))


def accumulate_plain(curve, xs, ys, valid, offset: int, plan: WitnessMsmPlan) -> Jac:
    """Round r adds the r-th point of every bucket's run that has one; a
    lane's adds happen in the same order as in the kernel."""
    device = xs.device
    ar = curve.arith(device)
    nw, nb, n = plan.nw, plan.nb, plan.n
    n_rows = xs.shape[0]
    xs, ys = L.u32(xs), L.u32(ys)
    s = plan.starts[:, :-1].reshape(-1).to(torch.int64)
    e = plan.starts[:, 1:].reshape(-1).to(torch.int64)
    acc = _inf64(curve, (nw * nb,), device)
    occ = int((e - s).max()) if nw * nb else 0
    for r in range(occ):
        lanes = torch.nonzero(s + r < e).flatten()
        enc = plan.order[lanes // nb, s[lanes] + r].to(torch.int64)
        neg = enc >= n
        row = torch.where(neg, enc - n, enc) - offset
        rowc = row.clamp(0, max(n_rows - 1, 0))
        ok = (row >= 0) & (row < n_rows) & valid[rowc]
        y = ys[rowc]
        y = ar.select(neg, ar.sub(ar.zeros_like(y), y), y)
        new = jac_add_affine(ar, tuple(t[lanes] for t in acc), xs[rowc], y, ok)
        for t, nt in zip(acc, new):
            t[lanes] = nt
    return tuple(L.to_i32(t) for t in acc)


def accumulate(curve, xs, ys, valid, offset: int, plan: WitnessMsmPlan) -> Jac:
    """Bucket sums [nw * nb] of the table rows (xs, ys, valid) under the
    plan; table row = scalar index - offset."""
    if not xs.is_cuda:
        return accumulate_plain(curve, xs, ys, valid, offset, plan)
    cs = curve.coord_shape
    for t in (xs, ys):
        if t.dtype != torch.int32 or tuple(t.shape[1:]) != cs or not t.is_contiguous():
            raise ValueError(f"point table must be contiguous int32 [N, {cs}]")
    if valid.dtype != torch.bool or tuple(valid.shape) != (xs.shape[0],) or not valid.is_cuda:
        raise ValueError("valid must be a CUDA bool tensor [N]")
    for t in (plan.order, plan.starts):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("plan tensors must be contiguous CUDA int32")
    lanes = plan.nw * plan.nb
    out = tuple(torch.empty((lanes,) + cs, dtype=torch.int32, device=xs.device) for _ in range(3))
    _build.launch(
        "zk_msm_accum", f"msm_accum_g{curve.group}", curve.group,
        xs.data_ptr(), ys.data_ptr(), valid.contiguous().data_ptr(), offset, xs.shape[0],
        plan.order.data_ptr(), plan.starts.data_ptr(), plan.nw, plan.nb, plan.n,
        *[t.data_ptr() for t in out],
    )
    return out


# ---------------------------------------------------------------------------
# Weighted bucket reduction (kernel B7) and its plain version
# ---------------------------------------------------------------------------


def seg_len(nb: int) -> int:
    """Segment length L ~ sqrt(nb), a power of two dividing nb."""
    return 1 << (nb.bit_length() // 2)


def reduce_plain(curve, buckets: Jac, nw: int, nb: int) -> Jac:
    """T_w = sum_j (j + 1) B_j per window, by the kernel's two passes of
    segmented running sums, in the kernel's order."""
    ar = curve.arith(buckets[0].device)
    buckets = tuple(L.u32(t) for t in buckets)
    seg = seg_len(nb)
    n_seg = nb // seg
    cs = curve.coord_shape
    b = tuple(t.reshape((nw, n_seg, seg) + cs) for t in buckets)
    device = buckets[0].device
    run = _inf64(curve, (nw, n_seg), device)
    tot = _inf64(curve, (nw, n_seg), device)
    for j in range(seg - 1, -1, -1):
        run = jac_add(ar, run, tuple(t[:, :, j] for t in b))
        tot = jac_add(ar, tot, run)
    acc = _inf64(curve, (nw,), device)
    for s in range(n_seg):
        acc = jac_add(ar, acc, tuple(t[:, s] for t in tot))
    run2 = _inf64(curve, (nw,), device)
    wsum = _inf64(curve, (nw,), device)
    for s in range(n_seg - 1, 0, -1):
        run2 = jac_add(ar, run2, tuple(t[:, s] for t in run))
        wsum = jac_add(ar, wsum, run2)
    for _ in range(seg.bit_length() - 1):
        wsum = jac_double(ar, wsum)
    return tuple(L.to_i32(t) for t in jac_add(ar, acc, wsum))


def reduce(curve, buckets: Jac, nw: int, nb: int) -> Jac:
    """Window totals [nw] from bucket sums [nw * nb]."""
    if not buckets[0].is_cuda:
        return reduce_plain(curve, buckets, nw, nb)
    cs = curve.coord_shape
    for t in buckets:
        if t.dtype != torch.int32 or tuple(t.shape) != (nw * nb,) + cs:
            raise ValueError(f"buckets must be int32 [{nw * nb}, {cs}]")
    seg = seg_len(nb)
    dev = buckets[0].device
    scratch = [torch.empty((nw * (nb // seg),) + cs, dtype=torch.int32, device=dev) for _ in range(6)]
    out = tuple(torch.empty((nw,) + cs, dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(
        "zk_msm_reduce", f"msm_reduce_g{curve.group}", curve.group,
        *[t.contiguous().data_ptr() for t in buckets], nw, nb, seg,
        *[t.data_ptr() for t in scratch], *[t.data_ptr() for t in out],
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
    the same window size share one Horner pass. `prefix_pad` aligns a
    table that covers only a suffix of the scalars (the C-query skips the
    n_public + 1 public wires): scalar i meets table row i - prefix_pad."""
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
        by_c.setdefault(plan.c, []).append((i, reduce(curve, buckets, plan.nw, plan.nb)))
    for c, items in by_c.items():
        totals = tuple(torch.stack([t[k] for _, t in items]) for k in range(3))
        for (i, _), pt in zip(items, curve.decode_jac(horner(curve, totals, c))):
            out[i] = pt
    for i, e in enumerate(extra):
        if e is not None:
            out[i] = e if out[i] is None else host_add(out[i], e)
    return out


def msm_shared(curve, table, plan: WitnessMsmPlan, host_add, host_mul, prefix_pad: int = 0):
    """One table's MSM against a shared plan (port of `msm_shared`)."""
    return msm_many(curve, [(table, plan, prefix_pad)], host_add, host_mul)[0]


def msm(curve, table, scalars: torch.Tensor, host_add, host_mul, c: Optional[int] = None):
    """MSM of one table against its own scalars [N, 8], with no heavy
    split (random scalars, as in the h-query)."""
    plan = plan_msm(scalars, c, split_heavy=False)
    return msm_shared(curve, table, plan, host_add, host_mul)
