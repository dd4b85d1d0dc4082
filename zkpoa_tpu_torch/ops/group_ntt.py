"""Lagrange-basis points from powers-of-tau points: an inverse NTT over a
group (G1 or G2) on the device.

Port of the stage loop of `zkpoa_tpu/prover/ptau.py` `lagrange_g1`
(:171-220), and of `_lagrange_g2` (:325-349), which the JAX package ran
as a host-Python G2 ladder (about 2.2e7 `g2_mul` calls at 2^21, so it
served only dev-scale domains). Here G1 and G2 share one path:

    L_i(tau) G = (1/m) sum_j w^{-ij} (tau^j G),

the inverse-DFT matrix applied to the points [tau^0 G, ..., tau^(m-1) G]
of the ceremony: a bit-reverse gather, log2 m decimation-in-time stages
u +- w^j v, then a scale by 1/m. Each stage is one launch of kernel K2
(csrc/scalar_mul.cu: a butterfly a lane, the twiddle's signed-window
ladder and both adds in registers, in place; a warp takes 32 consecutive
twiddles) for CUDA tensors, and `stage_plain` (K1's plain ladder and the
plain adds) for CPU tensors; the scale is K1 with one scalar for every
lane. The twiddles w^{-j} for j < m/2 are made once per domain on the
device (`ntt._twiddles`, the field NTT's table) and recoded into window
digits once (`booth_digits`); each stage reads every (m / 2 half)-th row.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fields.bn254 import R
from . import field_kernels as FK
from . import limbs as L
from .curve import Jac, booth_digits, jac_add, ladder_plain, scalar_mul_batch
from .limbs import BN254_FR
from .ntt import _bitrev, _twiddles


def stage_plain(ops, p: Jac, digits: torch.Tensor, log_half: int) -> Jac:
    """Plain version of K2: for each pair (u, v) = (i, i + half) of every
    block of 2 half, v' = [tw[i mod half]] v by K1's plain ladder on the
    twiddle's digits (`booth_digits`, [half, nd]), then (u + v', u - v') by
    the plain unified add, -v' negating y. Returns new tensors."""
    half = 1 << log_half
    m = p[0].shape[0]
    cs = ops.coord_shape
    blocks = tuple(t.reshape((m // (2 * half), 2, half) + cs) for t in p)
    u = tuple(t[:, 0].reshape((m // 2,) + cs) for t in blocks)
    v = tuple(t[:, 1].reshape((m // 2,) + cs) for t in blocks)
    vt = ladder_plain(ops, v, digits.repeat(m // (2 * half), 1))
    lo, hi = butterfly_plain(ops, u, vt)
    shape = (m // (2 * half), 1, half) + cs
    return tuple(
        torch.cat([a.reshape(shape), b.reshape(shape)], dim=1).reshape((m,) + cs)
        for a, b in zip(lo, hi))


def butterfly_plain(ops, u: Jac, vt: Jac):
    """(u + vt, u - vt) by the plain unified add, -vt negating y: the adds
    of a butterfly whose v is already scaled by its twiddle."""
    ar = ops.arith(u[0].device)
    u64, vt64 = tuple(L.u32(t) for t in u), tuple(L.u32(t) for t in vt)
    lo = jac_add(ar, u64, vt64)
    hi = jac_add(ar, u64, (vt64[0], ar.sub(ar.zeros_like(vt64[1]), vt64[1]), vt64[2]))
    return tuple(L.to_i32(t) for t in lo), tuple(L.to_i32(t) for t in hi)


def stage(ops, p: Jac, digits: torch.Tensor, log_half: int) -> Jac:
    """One butterfly stage on the twiddles' window digits [half, nd]:
    kernel K2 in place for CUDA points (returns them), the plain version
    for CPU points."""
    if p[0].is_cuda:
        return FK.group_ntt_stage(ops.group, p, digits, log_half)
    return stage_plain(ops, p, digits, log_half)


def lagrange_points(ops, sources: Sequence[Jac], m: int) -> List[Jac]:
    """[L_i(tau_s) G for i < m] as Jacobian points [m] for each source s,
    from its Jacobian tau-power points (source[j] = tau_s^j G, at least m
    rows), without tau. The sources' domains run side by side as one array
    of len(sources) m points: a stage pairs points only inside blocks of
    2 half, which never straddle two sources, so every stage and the scale
    is one launch for all of them."""
    log_m = m.bit_length() - 1
    if m != 1 << log_m or any(src[0].shape[0] < m for src in sources):
        raise ValueError(f"m must be a power of two and every source must have m = {m} "
                         "points")
    device = sources[0][0].device
    rev = _bitrev(log_m, device)
    cur = tuple(torch.cat([src[k][:m][rev] for src in sources]) for k in range(3))
    if log_m:
        # w^-j, j < m/2, recoded once for every stage
        digits = booth_digits(BN254_FR.from_mont(_twiddles(log_m, True, device)))
        for s in range(log_m):
            cur = stage(ops, cur, digits[:: m >> (s + 1)], s)
    m_inv = torch.from_numpy(BN254_FR.to_limbs([pow(m, -1, R)])).to(device)  # one scalar [1, 8]
    out = scalar_mul_batch(ops, cur, m_inv, 254)
    return [tuple(t[k * m : (k + 1) * m] for t in out) for k in range(len(sources))]
