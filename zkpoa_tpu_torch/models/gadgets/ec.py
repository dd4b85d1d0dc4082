# Copy of zkpoa_tpu/models/gadgets/ec.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Short-Weierstrass elliptic-curve gadgets over a foreign field, and the
ECDSA* verification circuit core.

Constraint-side equivalent of the reference's vendored circom-ecdsa /
batch-ecdsa secp256k1 gadget libraries (SURVEY.md §2.2: used by
circuits/layer_one.circom via ECDSAVerifyNoPubkeyCheck /
BatchECDSAVerifyNoPubkeyCheck). Built from the math on the bigint FF
gadgets — not a translation of those circuits.

ECDSA* (the starred variant, scripts/lib/ecdsa_star.ts:36-46): the prover
supplies the full point R = (r, r') — r' is the y-coordinate that plain
ECDSA discards — so verification is the group equation
    (msghash * s^-1) G + (r * s^-1) P == R
with no in-circuit square-root. We verify it with a Shamir double-scalar
ladder over incomplete additions made safe by an accumulator offset:
acc starts at a nothing-up-my-sleeve constant D (unknown discrete log),
every step doubles and conditionally adds via branchless 4-way muxes, and
the final 2^L * D offset is subtracted with a constant point. Exceptional
add cases (x1 == x2) are excluded by explicit inverse witnesses, so the
chord formulas are sound for any witness a malicious prover could supply.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ...fields.bn254 import R as P
from ..r1cs import LC, AnyLC, Circuit, Signal, _lc
from . import bigint as B
from .bigint import FF, FFSpec


@dataclass(frozen=True)
class ECSpec:
    """y^2 = x^3 + a x + b over FFSpec field (a = 0 for secp256k1)."""

    field: FFSpec
    a: int
    b: int
    gen: Tuple[int, int]
    order: int
    name: str = ""


def _sswu_ish_aux_point(spec: ECSpec, tag: str) -> Tuple[int, int]:
    """Deterministic nothing-up-my-sleeve curve point: hash a tag to x
    candidates, take the first on-curve x with even y. (Not constant-time,
    host-side only.)"""
    p = spec.field.p
    ctr = 0
    while True:
        h = hashlib.sha256(f"zkpoa-aux-point|{spec.name}|{tag}|{ctr}".encode()).digest()
        x = int.from_bytes(h + hashlib.sha256(h).digest(), "big") % p
        rhs = (x * x % p * x + spec.a * x + spec.b) % p
        y = pow(rhs, (p + 1) // 4, p) if p % 4 == 3 else _tonelli(rhs, p)
        if y is not None and y * y % p == rhs:
            if y % 2 == 1:
                y = p - y
            return (x, y)
        ctr += 1


def _tonelli(n: int, p: int) -> Optional[int]:
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, cc, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        bb = pow(cc, 1 << (m - i - 1), p)
        m, cc = i, bb * bb % p
        t, r = t * cc % p, r * bb % p
    return r


def _ec_add_host(spec: ECSpec, p1, p2):
    """Host affine add (None = infinity)."""
    pm = spec.field.p
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % pm == 0:
            return None
        lam = (3 * x1 * x1 + spec.a) * pow(2 * y1, -1, pm) % pm
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, pm) % pm
    x3 = (lam * lam - x1 - x2) % pm
    y3 = (lam * (x1 - x3) - y1) % pm
    return (x3, y3)


def _ec_mul_host(spec: ECSpec, pt, k: int):
    acc = None
    while k:
        if k & 1:
            acc = _ec_add_host(spec, acc, pt)
        pt = _ec_add_host(spec, pt, pt)
        k >>= 1
    return acc


class ECPoint:
    """In-circuit affine point (never infinity by construction)."""

    __slots__ = ("x", "y")

    def __init__(self, x: FF, y: FF):
        self.x = x
        self.y = y

    @property
    def value(self) -> Tuple[int, int]:
        return (self.x.value, self.y.value)


def ec_const(c: Circuit, spec: ECSpec, pt: Tuple[int, int]) -> ECPoint:
    return ECPoint(B.ff_const(c, spec.field, pt[0]), B.ff_const(c, spec.field, pt[1]))


def ec_witness(c: Circuit, spec: ECSpec, pt: Tuple[int, int]) -> ECPoint:
    return ECPoint(
        B.ff_witness(c, spec.field, pt[0]), B.ff_witness(c, spec.field, pt[1])
    )


def ec_on_curve(c: Circuit, spec: ECSpec, pt: ECPoint) -> None:
    """Constrain y^2 == x^3 + a x + b."""
    f = spec.field
    y2 = B.ff_mul(c, pt.y, pt.y)
    x2 = B.ff_mul(c, pt.x, pt.x)
    x3 = B.ff_mul(c, x2, pt.x)
    rhs = x3
    if spec.a:
        ax = B.ff_mul(c, pt.x, B.ff_const(c, f, spec.a))
        rhs = B.ff_add(c, rhs, ax)
    rhs = B.ff_add(c, rhs, B.ff_const(c, f, spec.b))
    B.ff_assert_equal(c, y2, rhs)


def ec_add_unequal(c: Circuit, spec: ECSpec, p1: ECPoint, p2: ECPoint) -> ECPoint:
    """Chord addition; constrains x1 != x2 (inverse witness), so the
    formulas are complete on the constrained domain."""
    dx = B.ff_sub(c, p2.x, p1.x)
    B.ff_inv(c, dx)  # proves dx != 0
    dy = B.ff_sub(c, p2.y, p1.y)
    lam = B.ff_div(c, dy, dx)
    lam2 = B.ff_mul(c, lam, lam)
    x3 = B.ff_sub(c, B.ff_sub(c, lam2, p1.x), p2.x)
    y3 = B.ff_sub(c, B.ff_mul(c, lam, B.ff_sub(c, p1.x, x3)), p1.y)
    return ECPoint(x3, y3)


def ec_double(c: Circuit, spec: ECSpec, p1: ECPoint) -> ECPoint:
    """Tangent doubling. No explicit 2y != 0 check: points reachable in our
    ladders are provably on-curve, and a prime-odd-order curve has no
    2-torsion — if 2y were 0 the lam*den == num constraint would force
    3x^2 + a == 0 with (x, 0) on the curve, which has no solution."""
    f = spec.field
    x2 = B.ff_mul(c, p1.x, p1.x)
    num = B.ff_add(c, B.ff_add(c, x2, B.ff_add(c, x2, x2)), B.ff_const(c, f, spec.a))
    den = B.ff_add(c, p1.y, p1.y)
    lam = B.ff_div(c, num, den)
    lam2 = B.ff_mul(c, lam, lam)
    x3 = B.ff_sub(c, B.ff_sub(c, lam2, p1.x), p1.x)
    y3 = B.ff_sub(c, B.ff_mul(c, lam, B.ff_sub(c, p1.x, x3)), p1.y)
    return ECPoint(x3, y3)


def ec_select(c: Circuit, sel: AnyLC, a: ECPoint, b: ECPoint) -> ECPoint:
    return ECPoint(B.ff_select(c, sel, a.x, b.x), B.ff_select(c, sel, a.y, b.y))


def ec_mux4(
    c: Circuit, s0: AnyLC, s1: AnyLC, pts: Sequence[ECPoint]
) -> ECPoint:
    """4-way mux by bits (s0 = low): out = pts[s0 + 2*s1]."""
    lo = ec_select(c, s0, pts[1], pts[0])
    hi = ec_select(c, s0, pts[3], pts[2])
    return ec_select(c, s1, hi, lo)


def shamir_double_mul(
    c: Circuit,
    spec: ECSpec,
    bits1: Sequence[AnyLC],  # scalar for base1, little-endian bits
    base1: Tuple[int, int],  # constant point (G)
    bits2: Sequence[AnyLC],  # scalar for base2
    base2: ECPoint,  # witness point (pubkey)
    tag: str = "shamir",
) -> ECPoint:
    """bits1 * base1 + bits2 * base2 via one interleaved ladder.

    acc := D; per step (MSB first): acc := 2*acc + M, with
    M = mux(D2, G+D2, P+D2, G+P+D2) by the two bits. The filler D2 is added
    on EVERY step, so its accumulated contribution is the data-independent
    constant (2^L - 1) * D2; together with 2^L * D it is removed by one
    final constant-point addition. The D/D2 offsets keep every intermediate
    addition well-defined for honest witnesses (hitting an exceptional case
    would exhibit a discrete-log relation with the hashed-to-curve D/D2);
    for malicious witnesses the chord formulas stay sound because x1 != x2
    is enforced by inverse witnesses."""
    assert len(bits1) == len(bits2)
    L = len(bits1)
    f = spec.field

    d_aff = _sswu_ish_aux_point(spec, tag + "|D")
    d2_aff = _sswu_ish_aux_point(spec, tag + "|D2")

    # table: D2, G + D2 (host consts), P + D2, G + P + D2 (in-circuit adds)
    d2_pt = ec_const(c, spec, d2_aff)
    g_d2_pt = ec_const(c, spec, _ec_add_host(spec, base1, d2_aff))
    p_d2_pt = ec_add_unequal(c, spec, base2, d2_pt)
    gp_d2_pt = ec_add_unequal(c, spec, base2, g_d2_pt)

    acc = ec_const(c, spec, d_aff)
    for i in range(L - 1, -1, -1):
        acc = ec_double(c, spec, acc)
        m = ec_mux4(c, bits1[i], bits2[i], [d2_pt, g_d2_pt, p_d2_pt, gp_d2_pt])
        acc = ec_add_unequal(c, spec, acc, m)

    # remove the constant offset 2^L * D + (2^L - 1) * D2
    off = _ec_add_host(
        spec,
        _ec_mul_host(spec, d_aff, 1 << L),
        _ec_mul_host(spec, d2_aff, (1 << L) - 1),
    )
    neg_off = (off[0], (f.p - off[1]) % f.p)
    return ec_add_unequal(c, spec, acc, ec_const(c, spec, neg_off))


# ---------------------------------------------------------------------------
# ECDSA*
# ---------------------------------------------------------------------------


def _init_secp() -> ECSpec:
    from ...fields import secp256k1 as S

    return ECSpec(
        field=B.SECP_FQ, a=0, b=7, gen=(S.GX, S.GY), order=S.N, name="secp256k1"
    )


SECP256K1_EC = _init_secp()


def ff_bits(c: Circuit, x: FF) -> List[Signal]:
    """Little-endian bit decomposition of an FF element, reusing the
    per-limb range-check bits when present."""
    if x.bits is not None:
        out: List[Signal] = []
        for limb_bits in x.bits:
            out.extend(limb_bits)
        return out
    from .core import num2bits

    out = []
    for limb in x.limbs:
        out.extend(num2bits(c, limb, x.spec.n))
    return out


def ecdsa_star_verify(
    c: Circuit,
    r: FF,  # mod-n element (x-coord of R)
    rprime: FF,  # mod-p element (y-coord of R)
    s: FF,  # mod-n
    msghash: FF,  # mod-n
    pubkey: ECPoint,
    tag: str = "sig",
) -> None:
    """Constrain (msghash/s) G + (r/s) P == (r, r').

    Register layouts match the reference layer-one inputs
    (circuits/layer_one.circom:19-23: r, rprime, s, msghash, pubkey as
    4x64-bit limbs)."""
    spec = SECP256K1_EC
    fr = B.SECP_FR

    ec_on_curve(c, spec, pubkey)

    sinv_val = pow(s.value, -1, fr.p)
    sinv = B.ff_witness(c, fr, sinv_val)
    one = B.ff_const(c, fr, 1)
    B.ff_mul_eq(c, s, sinv, one)

    u1_val = msghash.value * sinv_val % fr.p
    u2_val = r.value * sinv_val % fr.p
    u1 = B.ff_witness(c, fr, u1_val, keep_bits=True)
    u2 = B.ff_witness(c, fr, u2_val, keep_bits=True)
    B.ff_mul_eq(c, msghash, sinv, u1)
    B.ff_mul_eq(c, r, sinv, u2)

    r_pt = shamir_double_mul(
        c, spec, ff_bits(c, u1), spec.gen, ff_bits(c, u2), pubkey, tag=tag
    )

    # R.x == r as integers (r < n < p so limbwise equality is exact);
    # R.y == r'
    B.ff_assert_equal(c, r_pt.x, FF(spec.field, r.limbs, r.value))
    B.ff_assert_equal(c, r_pt.y, rprime)
