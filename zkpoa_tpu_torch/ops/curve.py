"""Batched BN254 G1 arithmetic on torch tensors.

Port of `zkpoa_tpu/ops/curve_jax.py`. Points are (x, y, z) tuples of
Montgomery limb tensors [..., 8] (G2, in `fp2.py`: [..., 2, 8]); infinity
is z == 0, affine points use z = 1.

`CurveOps.add` / `add_affine` / `double` launch the point kernels B3 / B2 /
B4 (csrc/point_ops.cu) for CUDA tensors and run the plain formulas below
for CPU tensors, as `curve_jax.py:232-251` dispatched to Pallas on the TPU.
The plain formulas are written to give the kernels' results limb for limb:
same formula order, canonical field values, and a P == -Q sum written as
all-zero coordinates. They compute every exceptional case beside the
generic one and select, where a kernel thread branches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import host
from . import field_kernels as FK
from . import limbs as L
from .limbs import BN254_FQ, FieldSpec


class Arith(NamedTuple):
    """Field vtable so one set of formulas serves Fp and Fp2."""

    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    dbl: Callable
    is_zero: Callable
    select: Callable  # (cond_batch, a, b)
    zeros_like: Callable
    one_like: Callable

    def mul_many(self, *pairs):
        """Several independent products as one batched call (the plain
        versions pay per call, not per element, at small batches)."""
        flat = torch.broadcast_tensors(*[t for pair in pairs for t in pair])
        out = self.mul(torch.stack(flat[0::2]), torch.stack(flat[1::2]))
        return out.unbind(0)


def fp_arith_plain(spec: FieldSpec, device) -> Arith:
    """Fp through the plain torch versions only (never a kernel), on int64
    tensors of u32 limb values."""
    f = L.plain64(spec, device)
    return Arith(
        add=f.add, sub=f.sub, mul=f.mul, sqr=lambda a: f.mul(a, a),
        dbl=lambda a: f.add(a, a), is_zero=L.is_zero, select=L.select,
        zeros_like=torch.zeros_like, one_like=lambda a: f.one.expand(a.shape),
    )


def run_plain(ar: Arith, formula, *args):
    """Run a plain point formula on int32 limb tensors: limbs go to int64
    u32 values on the way in and back on the way out (bool masks pass)."""
    conv = lambda t: L.u32(t) if t.dtype == torch.int32 else t  # noqa: E731
    args = [tuple(conv(t) for t in a) if isinstance(a, tuple) else conv(a) for a in args]
    return tuple(L.to_i32(t) for t in formula(ar, *args))


Jac = Tuple[Any, Any, Any]


def _sel3(ar: Arith, cond, a3, b3) -> Jac:
    return tuple(ar.select(cond, ac, bc) for ac, bc in zip(a3, b3))


def _exceptional(ar: Arith, p: Jac, out: Jac, same_x, same_y) -> Jac:
    """P == Q lanes take 2P, P == -Q lanes all-zero coordinates. The
    doubling is computed only when some lane needs it."""
    if bool(same_x.any()):
        out = _sel3(ar, same_x & same_y, jac_double(ar, p), out)
        zero = ar.zeros_like(out[0])
        out = _sel3(ar, same_x & ~same_y, (zero, zero, zero), out)
    return out


def jac_double(ar: Arith, p: Jac) -> Jac:
    """dbl-2009-l (a = 0); infinity stays infinity (z3 = 0)."""
    x, y, z = p
    a, b = ar.mul_many((x, x), (y, y))
    xb = ar.add(x, b)
    c, xb2 = ar.mul_many((b, b), (xb, xb))
    d = ar.dbl(ar.sub(xb2, ar.add(a, c)))
    e = ar.add(ar.dbl(a), a)
    f = ar.sqr(e)
    x3 = ar.sub(f, ar.dbl(d))
    c8 = ar.dbl(ar.dbl(ar.dbl(c)))
    edx, yz = ar.mul_many((e, ar.sub(d, x3)), (y, z))
    return (x3, ar.sub(edx, c8), ar.dbl(yz))


def jac_add(ar: Arith, p: Jac, q: Jac) -> Jac:
    """Unified Jacobian add, correct for every input pair (plain B3)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2, y1z2, y2z1, z1z2 = ar.mul_many((z1, z1), (z2, z2), (y1, z2), (y2, z1), (z1, z2))
    u1, u2, s1, s2 = ar.mul_many((x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1))
    h = ar.sub(u2, u1)
    r = ar.sub(s2, s1)
    hh, rr, z3 = ar.mul_many((h, h), (r, r), (z1z2, h))
    hhh, v = ar.mul_many((h, hh), (u1, hh))
    x3 = ar.sub(ar.sub(rr, hhh), ar.dbl(v))
    rvx, s1h = ar.mul_many((r, ar.sub(v, x3)), (s1, hhh))
    out = (x3, ar.sub(rvx, s1h), z3)

    p_inf = ar.is_zero(z1)
    q_inf = ar.is_zero(z2)
    out = _exceptional(ar, p, out, ar.is_zero(h), ar.is_zero(r))
    out = _sel3(ar, q_inf & ~p_inf, p, out)
    return _sel3(ar, p_inf, q, out)


def jac_add_affine(ar: Arith, p: Jac, xq, yq, q_valid) -> Jac:
    """Unified mixed add of affine points (z = 1 implied); q_valid masks
    out absent points (plain B2)."""
    x1, y1, z1 = p
    z1z1, yqz1 = ar.mul_many((z1, z1), (yq, z1))
    u2, s2 = ar.mul_many((xq, z1z1), (yqz1, z1z1))
    h = ar.sub(u2, x1)
    r = ar.sub(s2, y1)
    hh, rr, z3 = ar.mul_many((h, h), (r, r), (z1, h))
    hhh, v = ar.mul_many((h, hh), (x1, hh))
    x3 = ar.sub(ar.sub(rr, hhh), ar.dbl(v))
    rvx, y1h = ar.mul_many((r, ar.sub(v, x3)), (y1, hhh))
    out = (x3, ar.sub(rvx, y1h), z3)

    out = _exceptional(ar, p, out, ar.is_zero(h), ar.is_zero(r))
    out = _sel3(ar, ar.is_zero(z1), (xq, yq, ar.one_like(x3)), out)
    return _sel3(ar, ~q_valid, p, out)


class _CurveBase:
    """Shared dispatch of the point ops: kernels on the card, plain
    formulas on the CPU. Subclasses give `arith`, `group`, `coord_shape`."""

    group: int
    coord_shape: Tuple[int, ...]

    def double(self, p: Jac) -> Jac:
        if p[0].is_cuda:
            return FK.point_double(self.group, p)
        return run_plain(self.arith(p[0].device), jac_double, p)

    def add(self, p: Jac, q: Jac) -> Jac:
        if p[0].is_cuda:
            return FK.point_add(self.group, p, q)
        return run_plain(self.arith(p[0].device), jac_add, p, q)

    def add_affine(self, p: Jac, xq, yq, q_valid) -> Jac:
        if p[0].is_cuda:
            return FK.point_add_affine(self.group, p, xq, yq, q_valid)
        return run_plain(self.arith(p[0].device), jac_add_affine, p, xq, yq, q_valid)

    def infinity(self, batch_shape, device) -> Jac:
        shape = tuple(batch_shape) + self.coord_shape
        return tuple(torch.zeros(shape, dtype=torch.int32, device=device) for _ in range(3))


@dataclass(frozen=True)
class CurveOps(_CurveBase):
    """BN254 G1 (coordinates in Fq)."""

    field: FieldSpec = BN254_FQ
    group: int = FK.G1
    coord_shape: Tuple[int, ...] = (8,)
    name: str = "bn254_g1"

    def arith(self, device) -> Arith:
        return fp_arith_plain(self.field, device)

    def encode_coords(self, values, device) -> torch.Tensor:
        return self.field.encode(values, device)

    def encode_affine(self, points, device):
        """[(x, y) ints or None] -> (xs, ys, valid) Montgomery tensors."""
        xs = [0 if pt is None else pt[0] for pt in points]
        ys = [0 if pt is None else pt[1] for pt in points]
        valid = torch.tensor([pt is not None for pt in points], dtype=torch.bool)
        return self.encode_coords(xs, device), self.encode_coords(ys, device), valid.to(device)

    def decode_jac(self, p: Jac):
        """Jacobian tensors [N, 8] -> list of affine int tuples (None = inf)."""
        dec = self.field.decode
        xs, ys, zs = dec(p[0]), dec(p[1]), dec(p[2])
        mod = self.field.modulus
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, -1, mod)
            zi2 = zi * zi % mod
            out.append((x * zi2 % mod, y * zi2 % mod * zi % mod))
        return out


def jac_to_affine_mont(spec: FieldSpec, p: Jac):
    """Jacobian -> affine on the device: one batched inverse of z, then
    x/z^2 and y/z^3. Returns (xs, ys, valid); infinity -> valid False."""
    x, y, z = p
    valid = ~L.is_zero(z)
    zinv = L.mont_inv(spec, z)
    zinv2 = L.mont_mul(spec, zinv, zinv)
    xs = L.mont_mul(spec, x, zinv2)
    ys = L.mont_mul(spec, y, L.mont_mul(spec, zinv2, zinv))
    return xs, ys, valid


# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication (setup)
# ---------------------------------------------------------------------------

FB_WINDOW = 8  # scalar bits per fixed-base table row (2^8 entries a row)
_FB_HOST: Dict[tuple, tuple] = {}
_FB_DEV: Dict[tuple, tuple] = {}


def _flat_coords(pt_coord) -> list:
    return list(pt_coord) if isinstance(pt_coord, tuple) else [pt_coord]


def fixed_base_table(curve_name: str, base, host_add, n_bits: int):
    """Windowed fixed-base table, table[j][e] = (e << (w*j)) * base with
    w = FB_WINDOW, as
    plain int32 limb arrays (xs, ys [nwin, 2^w, k, 8], valid [nwin, 2^w]);
    entry 0 of each row is a dummy with valid False. Built once per process
    on the host with exact affine adds (port of `curve_jax.py:317`
    `fixed_base_table`)."""
    w = FB_WINDOW
    key = (curve_name, str(base), n_bits, w)
    if key in _FB_HOST:
        return _FB_HOST[key]
    nwin = (n_bits + w - 1) // w
    k = len(_flat_coords(base[0]))
    xs_i, ys_i, valid = [], [], np.zeros((nwin, 1 << w), dtype=bool)
    row_base = base
    for j in range(nwin):
        acc = None
        xs_i.extend([0] * k)
        ys_i.extend([0] * k)
        for e in range(1, 1 << w):
            acc = host_add(acc, row_base)
            xs_i.extend(_flat_coords(acc[0]))
            ys_i.extend(_flat_coords(acc[1]))
            valid[j, e] = True
        for _ in range(w):
            row_base = host_add(row_base, row_base)
    shape = (nwin, 1 << w, k, 8)
    xs = host.scalars_to_limbs_fast(xs_i).reshape(shape)
    ys = host.scalars_to_limbs_fast(ys_i).reshape(shape)
    _FB_HOST[key] = (xs, ys, valid)
    return _FB_HOST[key]


def fixed_base_device_table(ops, base, host_add, n_bits: int, device):
    """The fixed-base table of `base` as Montgomery tensors on `device`
    (xs, ys [nwin, 2^w, *coord], valid [nwin, 2^w]), encoded once per
    process and device."""
    dkey = (ops.name, str(base), n_bits, str(device))
    if dkey not in _FB_DEV:
        xs, ys, valid = fixed_base_table(ops.name, base, host_add, n_bits)
        shape = xs.shape[:2] + ops.coord_shape
        spec = ops.field
        enc = lambda a: spec.to_mont(torch.from_numpy(a).to(device)).reshape(shape)  # noqa: E731
        _FB_DEV[dkey] = (enc(xs), enc(ys), torch.from_numpy(valid).to(device))
    return _FB_DEV[dkey]


def fixed_base_mul_batch(ops, base, host_add, scalars: torch.Tensor, n_bits: int) -> Jac:
    """[k_i * base] for plain-limb scalars [N, 8] below 2^n_bits:
    ceil(n_bits / FB_WINDOW) mixed adds of table entries instead of n_bits
    double-and-adds (port of `curve_jax.py:351` `fixed_base_mul_batch` and
    `:369` `fixed_base_mul_batch_pallas`). CUDA scalars launch kernel B8
    (csrc/fixed_base.cu); CPU scalars take the plain version."""
    xs_t, ys_t, valid_t = fixed_base_device_table(ops, base, host_add, n_bits, scalars.device)
    if scalars.is_cuda:
        nwin = (n_bits + FB_WINDOW - 1) // FB_WINDOW
        return FK.fixed_base(ops.group, xs_t, ys_t, valid_t, scalars, nwin)
    return fixed_base_plain(ops, xs_t, ys_t, valid_t, scalars, n_bits)


def fixed_base_plain(ops, xs_t, ys_t, valid_t, scalars: torch.Tensor, n_bits: int) -> Jac:
    """Plain version of B8 (port of `curve_jax.py:445` `_fb_fold`):
    acc += table[j][digit_j] by the plain mixed-add formula, window by
    window, in int64 throughout; runs on any device and launches nothing."""
    w = FB_WINDOW  # divides 32, so a digit never straddles two limbs
    nwin = (n_bits + w - 1) // w
    ar = ops.arith(scalars.device)
    sc = L.u32(scalars)
    acc = tuple(L.u32(t) for t in ops.infinity((scalars.shape[0],), scalars.device))
    for j in range(nwin):
        limb, sh = divmod(j * w, 32)
        idx = (sc[:, limb] >> sh) & ((1 << w) - 1)
        acc = jac_add_affine(ar, acc, L.u32(xs_t[j][idx]), L.u32(ys_t[j][idx]), valid_t[j][idx])
    return tuple(L.to_i32(t) for t in acc)


BN254_G1 = CurveOps()
