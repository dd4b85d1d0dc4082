"""Distributed NTT over a mesh axis: the four-step decomposition with one
all-to-all a transform.

Port of `zkpoa_tpu/parallel/ntt_dist.py`. Four-step: with n = A*B and x
viewed as a matrix [A, B] (coefficient i = i1*B + i2 at [i1, i2]),

    X[k1 + A*k2] = NTT_B over i2 ( w_n^{i2*k1} * NTT_A over i1 (x)[k1, i2] )

so the forward transform is: (1) size-A NTTs down the columns (each rank
holds a block of B/D columns, the transforms a batch of the NTT pass
kernel), (2) a twiddle multiply, (3) one `all_to_all_single` on the axis's
group that reshards columns to rows, (4) size-B NTTs along the rows. The
output Z[k1, k2] = X[k1 + A*k2] lies row-sharded (the "transposed evals"
layout); the inverse runs the steps backwards. Every rank holds the inputs
in full and takes its block; `quotient_dist` returns the natural-order h
on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..fields.bn254 import FR_GENERATOR, R
from ..host import domain_root
from ..ops import limbs as L
from ..ops.limbs import BN254_FR
from ..ops.ntt import _cached, ntt, pow_table
from .mesh import axis_size


def _pow_table(base: int, count: int, device) -> torch.Tensor:
    """[base^j for j < count] as Montgomery limbs on the device, built
    once per device (the tables of `ops/ntt.py`)."""
    return _cached(("pow", base, count, str(device)), lambda: pow_table(base, count, device))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's leading dim to rank j of the group; the received
    chunks stacked along a new leading dim in source order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    d = dist.get_world_size(group)
    return out.view((d, x.shape[0] // d) + tuple(x.shape[1:]))


def ntt_dist_local(x_local: torch.Tensor, log_n: int, mesh: DeviceMesh, axis: str,
                   inverse: bool, w_pows: torch.Tensor) -> torch.Tensor:
    """This rank's part of the distributed transform.

    Forward: x_local [A, B/D, 8] natural coefficients (a column block) ->
    [A/D, B, 8] transposed evaluations (a row block). Inverse: the exact
    reverse. w_pows: the n powers of the domain root (its inverse for the
    inverse transform)."""
    n = 1 << log_n
    spec = BN254_FR
    group = mesh.get_group(axis)
    d, idx = axis_size(mesh, axis), mesh.get_local_rank(axis)
    device = x_local.device
    if inverse:
        a_loc, b = x_local.shape[0], x_local.shape[1]
        z = ntt(x_local.contiguous(), inverse=True)  # size-B transforms along the rows
        k1 = idx * a_loc + torch.arange(a_loc, device=device)
        exps = (k1[:, None] * torch.arange(b, device=device)[None, :]) % n
        z = L.mont_mul(spec, z, w_pows[exps])
        # rows -> columns: [A/D, B] -> [A, B/D]
        z = z.view(a_loc, d, b // d, 8).transpose(0, 1)
        z = _all_to_all(z, group).reshape(d * a_loc, b // d, 8)
        z = ntt(z.transpose(0, 1).contiguous(), inverse=True)  # size-A down the columns
        return z.transpose(0, 1).contiguous()
    a, b_loc = x_local.shape[0], x_local.shape[1]
    y = ntt(x_local.transpose(0, 1).contiguous(), inverse=False)  # [B/D, A]
    y = y.transpose(0, 1)
    i2 = idx * b_loc + torch.arange(b_loc, device=device)
    exps = (torch.arange(a, device=device)[:, None] * i2[None, :]) % n
    y = L.mont_mul(spec, y.contiguous(), w_pows[exps])
    # columns -> rows: [A, B/D] -> [A/D, B]
    y = _all_to_all(y, group)  # [D (source column block), A/D, B/D]
    y = y.transpose(0, 1).reshape(a // d, d * b_loc, 8)
    return ntt(y.contiguous(), inverse=False)  # size-B transforms along the rows


def _split_ab(n: int, ndev: int) -> Tuple[int, int]:
    """Pick A, B with n = A*B, both multiples of ndev, A as square-ish."""
    log_n = n.bit_length() - 1
    la = log_n // 2
    a = 1 << la
    b = n // a
    assert a % ndev == 0 and b % ndev == 0, (
        f"four-step split A={a}, B={b} must both be divisible by {ndev}"
    )
    return a, b


def quotient_dist(a_ev, b_ev, c_ev, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """Distributed QAP quotient h(X) = (A*B - C)/Z: the multi-rank version
    of `ops.ntt.quotient`. Inputs are natural-order domain evaluations
    [n, 8] (Montgomery), held in full by every rank; the output is h's
    coefficients [n, 8] in natural order on every rank, limb for limb the
    one-device quotient. Each of the 7 transforms does one all-to-all;
    everything else is elementwise on the blocks."""
    spec = BN254_FR
    n = a_ev.shape[0]
    log_n = n.bit_length() - 1
    d, idx = axis_size(mesh, axis), mesh.get_local_rank(axis)
    a, b = _split_ab(n, d)
    device = a_ev.device

    w_fwd = _pow_table(domain_root(log_n), n, device)
    w_inv = _pow_table(pow(domain_root(log_n), -1, R), n, device)
    g = FR_GENERATOR
    g_pows = _pow_table(g, n, device)
    ginv_pows = _pow_table(pow(g, -1, R), n, device)
    zinv = spec.encode([pow((pow(g, n, R) - 1) % R, -1, R)], device)

    # natural evals [n] -> transposed layout Z[k1, k2] = ev[k1 + A*k2], this rank's rows
    rows = slice(idx * (a // d), (idx + 1) * (a // d))

    def to_l1(ev):
        return ev.reshape(b, a, 8).transpose(0, 1)[rows].contiguous()

    # coefficient index i1*B + i2 of this rank's column block [A, B/D]
    b_loc = b // d
    i2 = idx * b_loc + torch.arange(b_loc, device=device)
    gexp = (torch.arange(a, device=device)[:, None] * b + i2[None, :]) % n

    def fwd_coset(coef):
        coef = L.mont_mul(spec, coef, g_pows[gexp])
        return ntt_dist_local(coef, log_n, mesh, axis, False, w_fwd)

    a_s, b_s, c_s = (fwd_coset(ntt_dist_local(to_l1(ev), log_n, mesh, axis, True, w_inv))
                     for ev in (a_ev, b_ev, c_ev))
    h_s = L.mont_mul(spec, L.sub_mod(spec, L.mont_mul(spec, a_s, b_s), c_s), zinv)
    h_c = ntt_dist_local(h_s, log_n, mesh, axis, True, w_inv)
    h_c = L.mont_mul(spec, h_c, ginv_pows[gexp]).contiguous()  # [A, B/D]
    # the column blocks of every rank -> the natural [A, B] matrix
    parts = [torch.empty_like(h_c) for _ in range(d)]
    dist.all_gather(parts, h_c, group=mesh.get_group(axis))
    return torch.stack(parts, dim=1).reshape(n, 8)
