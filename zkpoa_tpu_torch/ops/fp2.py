"""Batched Fp2 arithmetic and BN254 G2 point ops on torch tensors.

Port of `zkpoa_tpu/ops/fp2_jax.py`. Fp2 = Fp[u]/(u^2 + 1); an element is
one tensor [..., 2, 8] (c0, c1 stacked) rather than JAX's tuple, so that a
coordinate is one contiguous array for the kernels. `G2Ops` launches the
G2 instances of the point kernels (csrc/point_ops.cu) for CUDA tensors and
runs the shared plain formulas of `curve.py` over `fp2_arith_plain` for
CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from ..fields import bn254
from . import field_kernels as FK
from . import limbs as L
from .curve import Arith, Jac, _CurveBase
from .limbs import BN254_FQ, FieldSpec


def _fp2(mul: Callable, add: Callable, sub: Callable):
    """Fp2 mul / sqr over a base-field (mul, add, sub) triple."""

    def f2mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        t = mul(torch.stack([a0, a1, add(a0, a1)], -2), torch.stack([b0, b1, add(b0, b1)], -2))
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        return torch.stack([sub(t0, t1), sub(sub(t2, t0), t1)], -2)

    def f2sqr(a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t = mul(torch.stack([add(a0, a1), a0], -2), torch.stack([sub(a0, a1), a1], -2))
        return torch.stack([t[..., 0, :], add(t[..., 1, :], t[..., 1, :])], -2)

    return f2mul, f2sqr


def fp2_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).flatten(-2).all(dim=-1)


def fp2_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None, None], a, b)


def fp2_arith_plain(device) -> Arith:
    """Fp2 through the plain torch field versions only (never a kernel), on
    int64 tensors of u32 limb values."""
    f = L.plain64(BN254_FQ, device)
    mul, sqr = _fp2(f.mul, f.add, f.sub)
    one = torch.stack([f.one, torch.zeros_like(f.one)])
    return Arith(
        add=f.add, sub=f.sub, mul=mul, sqr=sqr, dbl=lambda a: f.add(a, a),
        is_zero=fp2_is_zero, select=fp2_select,
        zeros_like=torch.zeros_like, one_like=lambda a: one.expand(a.shape),
    )


# Fp2 through the routed field ops (B1 kernels on the card)
_S = BN254_FQ
fp2_mul, fp2_sqr = _fp2(
    lambda a, b: L.mont_mul(_S, a, b), lambda a, b: L.add_mod(_S, a, b),
    lambda a, b: L.sub_mod(_S, a, b),
)


def fp2_inv(a: torch.Tensor) -> torch.Tensor:
    """1/(c0 + c1 u) = (c0 - c1 u)/(c0^2 + c1^2), one batched Fp inverse."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = L.mont_mul(_S, a, a)
    ninv = L.mont_inv(_S, L.add_mod(_S, sq[..., 0, :], sq[..., 1, :]))
    return torch.stack([L.mont_mul(_S, a0, ninv), L.mont_mul(_S, L.neg_mod(_S, a1), ninv)], -2)


def g2_jac_to_affine_mont(p: Jac):
    """Batched G2 Jacobian -> affine (Fp2 coords): (xs, ys, valid)."""
    x, y, z = p
    valid = ~fp2_is_zero(z)
    zinv = fp2_inv(z)
    zinv2 = fp2_mul(zinv, zinv)
    return fp2_mul(x, zinv2), fp2_mul(y, fp2_mul(zinv2, zinv)), valid


@dataclass(frozen=True)
class G2Ops(_CurveBase):
    """BN254 G2 on the twist over Fp2; coordinates [..., 2, 8]."""

    field: FieldSpec = BN254_FQ
    group: int = FK.G2
    coord_shape: Tuple[int, ...] = (2, 8)
    name: str = "bn254_g2"

    def arith(self, device) -> Arith:
        return fp2_arith_plain(device)

    def encode_coords(self, values, device) -> torch.Tensor:
        """[(c0, c1) ints] -> [N, 2, 8] Montgomery tensor."""
        flat = [c for v in values for c in v]
        return self.field.encode(flat, device).reshape(len(values), 2, 8)

    def encode_affine(self, points, device):
        zero = (0, 0)
        xs = [zero if pt is None else pt[0] for pt in points]
        ys = [zero if pt is None else pt[1] for pt in points]
        valid = torch.tensor([pt is not None for pt in points], dtype=torch.bool)
        return self.encode_coords(xs, device), self.encode_coords(ys, device), valid.to(device)

    def decode_jac(self, p: Jac):
        dec = self.field.decode
        xs, ys, zs = (dec(c) for c in p)
        out = []
        for i in range(len(zs) // 2):
            z = (zs[2 * i], zs[2 * i + 1])
            if z == (0, 0):
                out.append(None)
                continue
            zinv = bn254.fp2_inv(z)
            zinv2 = bn254.fp2_mul(zinv, zinv)
            zinv3 = bn254.fp2_mul(zinv2, zinv)
            x = bn254.fp2_mul((xs[2 * i], xs[2 * i + 1]), zinv2)
            y = bn254.fp2_mul((ys[2 * i], ys[2 * i + 1]), zinv3)
            out.append((x, y))
        return out


BN254_G2 = G2Ops()
