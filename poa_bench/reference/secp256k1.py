"""Frozen copy of the port's pure-Python secp256k1 (`zkpoa_tpu_torch/fields/secp256k1.py`)."""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

Point = Optional[Tuple[int, int]]  # None = infinity


def inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 7) % P == 0


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * inv_mod(2 * y1, P) % P
    else:
        lam = (y2 - y1) * inv_mod(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def mul(pt: Point, k: int) -> Point:
    k %= N
    result: Point = None
    addend = pt
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def pubkey_from_private(pvt: int) -> Tuple[int, int]:
    pt = mul(G, pvt)
    assert pt is not None
    return pt


def lift_x(x: int, y_parity: int) -> Point:
    """Recover the curve point with given x and y parity (None if not on curve)."""
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if y % 2 != y_parity:
        y = P - y
    return (x, y)


class EcdsaStarSignature(NamedTuple):
    r: int
    r_prime: int  # y-coordinate of the R point
    s: int
    msghash: int
    pubkey: Tuple[int, int]


def ecdsa_verify(r: int, s: int, msghash: int, pubkey: Tuple[int, int]) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    s_inv = inv_mod(s, N)
    u1 = msghash * s_inv % N
    u2 = r * s_inv % N
    pt = add(mul(G, u1), mul(pubkey, u2))
    if pt is None:
        return False
    return pt[0] % N == r


def ecdsa_star_from_ecdsa(r: int, s: int, msghash: int, pubkey: Tuple[int, int]) -> EcdsaStarSignature:
    """Compute r' = y-coord of R = (m s^-1)G + (r s^-1)Pk (ecdsa_star.ts:36-46)."""
    s_inv = inv_mod(s, N)
    r_pt = add(mul(G, msghash * s_inv % N), mul(pubkey, r * s_inv % N))
    if r_pt is None or r_pt[0] % N != r:
        raise ValueError("invalid ECDSA signature; cannot convert to ECDSA*")
    return EcdsaStarSignature(r=r, r_prime=r_pt[1], s=s, msghash=msghash, pubkey=pubkey)


def ecdsa_star_verify(sig: EcdsaStarSignature) -> bool:
    """Direct ECDSA* check: R = (r, r') must be on curve, and
    s·R == m·G + r·Pk (the form the layer-1 circuit proves)."""
    r_pt = (sig.r, sig.r_prime)
    if not is_on_curve(r_pt):
        return False
    lhs = mul(r_pt, sig.s)
    rhs = add(mul(G, sig.msghash), mul(sig.pubkey, sig.r))
    return lhs == rhs


def ecdsa_sign(pvt: int, msghash: int, nonce: int) -> Tuple[int, int]:
    """Deterministic-nonce ECDSA sign (test fixtures only; nonce supplied)."""
    k = nonce % N
    r_pt = mul(G, k)
    assert r_pt is not None
    r = r_pt[0] % N
    s = inv_mod(k, N) * (msghash + r * pvt) % N
    assert r != 0 and s != 0
    return r, s


def recover_pubkey(r: int, s: int, msghash: int, recovery_id: int) -> Tuple[int, int]:
    """Standard ECDSA public-key recovery (ethers.recoverPublicKey behavior)."""
    x = r + (recovery_id >> 1) * N
    r_pt = lift_x(x, recovery_id & 1)
    if r_pt is None:
        raise ValueError("invalid recovery data")
    r_inv = inv_mod(r, N)
    pk = mul(add(mul(r_pt, s), neg(mul(G, msghash))), r_inv)
    if pk is None:
        raise ValueError("recovered point at infinity")
    return pk
