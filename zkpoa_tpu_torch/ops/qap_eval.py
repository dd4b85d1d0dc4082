"""Sparse R1CS evaluation on the device: the QAP domain evaluations
<A_i, w>, <B_i, w>, <C_i, w> (prover) and the per-wire QAP polynomials at
tau (setup), as sparse matrix-vector products over Fr.

Port of `zkpoa_tpu/ops/qap_eval.py`. Each row's product pool[cid] * vec[gather]
is one Montgomery product (kernel B1 on the card; the Montgomery factors
cancel, so the product is a plain value < r). The products are accumulated
with `index_add_` into int64 sums of their 16-bit halves: a half is below
2^16, so a target can take 2^47 rows before a sum overflows — exact for any
fan-in, including the constant wire, which meets more than 2^16 rows in
every real circuit (the JAX package needs its `_spmv_safe` path for that).
One carry normalisation and a modular reduction finish each output.

A system's operands, the int32 index arrays of its three matrices and its
coefficient pool, go to a device once, at its first evaluation there, and
stay with the packed system (`_operands`): setup fills them, and every
prove after it copies only its witness. The chunks slice those tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import trace
from . import limbs as L
from .limbs import BN254_FR

CHUNK_ROWS = 1 << 22  # rows per product/scatter chunk (bounds scratch memory)
_POS = 19  # 16-bit positions of an accumulator: 256 bits + room for 2^47 rows


def _reduce_sums(acc: torch.Tensor) -> torch.Tensor:
    """int64 [n, 16] sums of 16-bit halves -> [n, 8] plain limbs mod r."""
    spec = BN254_FR
    t = torch.zeros(acc.shape[:-1] + (_POS,), dtype=torch.int64, device=acc.device)
    t[..., :16] = acc
    for _ in range(4):  # positions < 2^47 -> <= 2^16 after four passes
        hi = t >> 16
        t = t & L.MASK16
        t[..., 1:] += hi[..., :-1]
    lo = t & L.MASK16
    cin, _ = L._lookahead(t > L.MASK16, lo == L.MASK16)
    t = (lo + cin) & L.MASK16
    low = L.to_i32(t[..., 0:16:2] | (t[..., 1:16:2] << 16))
    extra = t[..., 16] | (t[..., 17] << 16) | (t[..., 18] << 32)  # < 2^48
    e = torch.zeros_like(t[..., :8])
    e[..., 0] = extra & L.MASK32
    e[..., 1] = extra >> 32
    r2 = spec.limbs_of(spec.r2, acc.device)
    lo_mod = spec.from_mont(L.mont_mul(spec, low, r2))  # low < 2^256 -> low mod r
    hi_mod = L.mont_mul(spec, L.to_i32(e), r2)  # extra * 2^256 mod r
    return L.add_mod(spec, lo_mod, hi_mod)


def _copy(a: np.ndarray, device) -> torch.Tensor:
    """One host array on the device, as it is (int32 indices stay 4 bytes
    an entry)."""
    trace.count("h2d_bytes", a.nbytes, site="spmv_operands")
    trace.count("host_sync", site="spmv_operands")  # a pageable copy waits on the stream
    return torch.from_numpy(a).to(device)


def _operands(packed, device: torch.device):
    """The SpMV operands of a packed system on `device`: each matrix's
    (idx, wire, cid) as int32 tensors and the coefficient pool in
    Montgomery form. Copied at a system's first evaluation on a device and
    kept in the system's own `_spmv_operands` (keyed by device), so they
    are freed with it; every later evaluation, setup's and each prove's,
    takes them from there."""
    cache = packed.__dict__.setdefault("_spmv_operands", {})
    ops = cache.get(device)
    trace.count("spmv_operands", site="hit" if ops is not None else "fill")
    if ops is None:
        mats = tuple(tuple(_copy(a, device) for a in (m.idx, m.wire, m.cid))
                     for m in (packed.a, packed.b, packed.c))
        ops = cache[device] = (mats, BN254_FR.to_mont(_copy(packed.pool_limbs, device)))
    return ops


def spmv(scatter: torch.Tensor, gather: torch.Tensor, cid: torch.Tensor,
         pool_mont: torch.Tensor, vec: torch.Tensor, out_size: int) -> torch.Tensor:
    """out[scatter] += pool[cid] * vec[gather] over int32 rows on vec's
    device; plain limbs out [out_size, 8]. Serves both directions (prover:
    scatter = constraint, gather = wire; setup: scatter = wire, gather =
    constraint)."""
    acc = torch.zeros((out_size, 16), dtype=torch.int64, device=vec.device)
    for off in range(0, len(scatter), CHUNK_ROWS):
        sl = slice(off, off + CHUNK_ROWS)
        prod = L.mont_mul(BN254_FR, pool_mont[cid[sl]], vec[gather[sl]])
        acc.index_add_(0, scatter[sl], L._split16(L.u32(prod)))
    return _reduce_sums(acc)


def eval_at_tau_device(packed, lag_plain: torch.Tensor, n_wires: int):
    """Setup-side transposed SpMV: per-wire A_k(tau), B_k(tau), C_k(tau)
    from the Lagrange values lag_plain [m, 8]; three [n_wires, 8] plain
    tensors (port of `qap_eval.py:141`)."""
    mats, pool_mont = _operands(packed, lag_plain.device)
    return tuple(spmv(wire, idx, cid, pool_mont, lag_plain, n_wires)
                 for idx, wire, cid in mats)


def _ab_pointwise(a_ev: torch.Tensor, b_ev: torch.Tensor) -> torch.Tensor:
    """C = A*B pointwise for systems that store no C matrix (a .zkey)."""
    spec = BN254_FR
    am = L.mont_mul(spec, a_ev, spec.limbs_of(spec.r2, a_ev.device))
    return L.mont_mul(spec, am, b_ev)


def eval_matrices_device(packed, witness: torch.Tensor,
                         domain_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed R1CS + plain witness limbs [n_wires, 8] on a device ->
    (a, b, c) plain [domain, 8], zero beyond n_constraints (port of
    `qap_eval.py:163`)."""
    (a, b, c), pool_mont = _operands(packed, witness.device)
    ev = lambda m: spmv(*m, pool_mont, witness, domain_size)  # noqa: E731
    a_ev, b_ev = ev(a), ev(b)
    if len(c[0]) == 0 and packed.n_constraints:
        return a_ev, b_ev, _ab_pointwise(a_ev, b_ev)
    return a_ev, b_ev, ev(c)
