# Copy of zkpoa_tpu/fields/bn254.py; only its imports, and the reference repository's paths in its text, are rewritten.
"""Exact host-side BN254 (alt_bn128) arithmetic: base/scalar fields, the
Fp2/Fp6/Fp12 tower, G1/G2 curve ops, and the optimal-ate pairing.

This is the *referee* math of the framework: trusted setup, verification-key
handling, Groth16 verification, and recursion-input "sanitization" (the
equivalent of the reference's ``scripts/sanitize_groth16_proof.py``, which used
py_ecc for e(-alpha, beta)) all run through this module on the host. The TPU
compute path (``zkpoa_tpu.ops``) carries the hot MSM/NTT/witness work and is
cross-checked against this module in tests.

Design notes
------------
* Pure-Python integers end to end — proof data must never touch floats.
* Fp2/Fp6/Fp12 are implemented as a tower (u^2 = -1, v^3 = xi = 9+u,
  w^2 = v) with Karatsuba-ish multiplication and cheap tower inversion,
  so the Miller loop can run in affine coordinates.
* The pairing follows the standard optimal-ate recipe for BN curves:
  Miller loop over 6x+2 with the two Frobenius line corrections, then the
  final exponentiation (p^12-1)/r split into the easy part and a plain
  square-and-multiply hard part (correctness-first; the verifier is not a
  hot path — proving is, and proving needs no pairings).

Reference behavior being matched (not copied): reference scripts/
sanitize_groth16_proof.py:39-72 (e(-alpha,beta) precompute, vkey massage) and
snarkjs `groth16 verify` semantics (scripts/g16_verify.sh:212-216).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

# ---------------------------------------------------------------------------
# Parameters (standard alt_bn128 / BN254 constants)
# ---------------------------------------------------------------------------

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3  # curve: y^2 = x^3 + 3

# BN parameter x ("t" in some papers); 6x+2 is the ate loop count.
X_PARAM = 4965661367192848881
ATE_LOOP_COUNT = 6 * X_PARAM + 2  # 29793968203157093288

G1_GEN = (1, 2)
# Standard generator of G2 on the twist y^2 = x^3 + 3/(9+u) over Fp2.
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# 2-adicity of Fr (r - 1 = 2^28 * odd): sizes the radix-2 NTT domain.
TWO_ADICITY = 28
# 5 is the smallest generator of Fr* for this r (matches snarkjs/ffjavascript).
FR_GENERATOR = 5

Fp2E = Tuple[int, int]
Fp6E = Tuple[Fp2E, Fp2E, Fp2E]
Fp12E = Tuple[Fp6E, Fp6E]

# ---------------------------------------------------------------------------
# Base field Fp and scalar field Fr (plain ints mod P / mod R)
# ---------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, -1, P)


def fr_inv(a: int) -> int:
    return pow(a, -1, R)


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FP2_ZERO: Fp2E = (0, 0)
FP2_ONE: Fp2E = (1, 0)
XI: Fp2E = (9, 1)  # the sextic-twist non-residue 9 + u


def fp2_add(a: Fp2E, b: Fp2E) -> Fp2E:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a: Fp2E, b: Fp2E) -> Fp2E:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a: Fp2E) -> Fp2E:
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a: Fp2E, b: Fp2E) -> Fp2E:
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sq(a: Fp2E) -> Fp2E:
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a: Fp2E, k: int) -> Fp2E:
    return (a[0] * k % P, a[1] * k % P)


def fp2_inv(a: Fp2E) -> Fp2E:
    a0, a1 = a
    norm_inv = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * norm_inv % P, -a1 * norm_inv % P)


def fp2_conj(a: Fp2E) -> Fp2E:
    return (a[0], -a[1] % P)


def fp2_mul_xi(a: Fp2E) -> Fp2E:
    """Multiply by xi = 9 + u."""
    a0, a1 = a
    return ((9 * a0 - a1) % P, (9 * a1 + a0) % P)


def fp2_pow(a: Fp2E, e: int) -> Fp2E:
    result = FP2_ONE
    base = a
    while e:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sq(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

FP6_ZERO: Fp6E = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE: Fp6E = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a: Fp6E, b: Fp6E) -> Fp6E:
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a: Fp6E, b: Fp6E) -> Fp6E:
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a: Fp6E) -> Fp6E:
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a: Fp6E, b: Fp6E) -> Fp6E:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), fp2_mul_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_sq(a: Fp6E) -> Fp6E:
    return fp6_mul(a, a)


def fp6_mul_by_v(a: Fp6E) -> Fp6E:
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a: Fp6E) -> Fp6E:
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sq(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sq(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sq(a1), fp2_mul(a0, a2))
    t = fp2_inv(
        fp2_add(
            fp2_add(fp2_mul(a0, c0), fp2_mul_xi(fp2_mul(a2, c1))),
            fp2_mul_xi(fp2_mul(a1, c2)),
        )
    )
    return (fp2_mul(t, c0), fp2_mul(t, c1), fp2_mul(t, c2))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FP12_ZERO: Fp12E = (FP6_ZERO, FP6_ZERO)
FP12_ONE: Fp12E = (FP6_ONE, FP6_ZERO)


def fp12_add(a: Fp12E, b: Fp12E) -> Fp12E:
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a: Fp12E, b: Fp12E) -> Fp12E:
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a: Fp12E, b: Fp12E) -> Fp12E:
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sq(a: Fp12E) -> Fp12E:
    return fp12_mul(a, a)


def fp12_neg(a: Fp12E) -> Fp12E:
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_conj(a: Fp12E) -> Fp12E:
    """Conjugation a0 - a1 w (the p^6 Frobenius)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a: Fp12E) -> Fp12E:
    a0, a1 = a
    t = fp6_inv(fp6_sub(fp6_sq(a0), fp6_mul_by_v(fp6_sq(a1))))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_pow(a: Fp12E, e: int) -> Fp12E:
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sq(base)
        e >>= 1
    return result


# Frobenius (x -> x^p) on Fp12 in the tower basis. gamma constants are
# xi^((p-1)/6) powers; computed once at import (cheap: 6 fp2_pows).
_G = fp2_pow(XI, (P - 1) // 6)
_FROB_GAMMA1: List[Fp2E] = [FP2_ONE]
for _ in range(5):
    _FROB_GAMMA1.append(fp2_mul(_FROB_GAMMA1[-1], _G))


def fp12_frobenius(a: Fp12E) -> Fp12E:
    """a -> a^p using conjugation on Fp2 coefficients + gamma twists.

    Basis: element = sum_{i<6} c_i * w^i with c_i in Fp2, where
    (a0=(c0,c2,c4), a1=(c1,c3,c5)) in the tower layout. x^p conjugates each
    Fp2 coefficient and multiplies c_i by gamma1[i] = xi^(i(p-1)/6).
    """
    (c0, c2, c4), (c1, c3, c5) = a
    d = [fp2_conj(c) for c in (c0, c1, c2, c3, c4, c5)]
    d = [fp2_mul(d[i], _FROB_GAMMA1[i]) for i in range(6)]
    return ((d[0], d[2], d[4]), (d[1], d[3], d[5]))


# ---------------------------------------------------------------------------
# G1 (affine, None = infinity)
# ---------------------------------------------------------------------------

G1Point = Tuple[int, int]


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * fp_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fp_inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    k %= R
    result = None
    addend = pt
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# G2 (affine over Fp2, None = infinity) — points live on the twist
# ---------------------------------------------------------------------------

B2: Fp2E = fp2_mul((B, 0), fp2_inv(XI))  # 3 / (9 + u)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fp2_sub(fp2_sub(fp2_sq(y), fp2_mul(fp2_sq(x), x)), B2) == FP2_ZERO


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        lam = fp2_mul(fp2_scalar(fp2_sq(x1), 3), fp2_inv(fp2_scalar(y1, 2)))
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sq(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R
    result = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------

Fp12Point = Tuple[Fp12E, Fp12E]


def _untwist(q) -> Fp12Point:
    """Map a twist point (x', y') in Fp2 to E(Fp12): (x' w^2, y' w^3)."""
    x, y = q
    # w^2 = v, w^3 = v*w in the tower. x' * v sits at Fp6 coefficient 1 of c0;
    # y' * v * w sits at Fp6 coefficient 1 of c1.
    xf: Fp12E = ((FP2_ZERO, x, FP2_ZERO), FP6_ZERO)
    yf: Fp12E = (FP6_ZERO, (FP2_ZERO, y, FP2_ZERO))
    return (xf, yf)


def _fp12_point_neg(q: Fp12Point) -> Fp12Point:
    return (q[0], fp12_neg(q[1]))


def _fp12_point_frob(q: Fp12Point) -> Fp12Point:
    return (fp12_frobenius(q[0]), fp12_frobenius(q[1]))


def _embed_g1(p) -> Fp12Point:
    x, y = p
    return (
        (((x, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO),
        (((y, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO),
    )


def _line(r: Fp12Point, q: Fp12Point, pt: Fp12Point) -> Tuple[Fp12E, Fp12Point]:
    """Evaluate the line through r, q at pt; return (value, r+q).

    Affine chord/tangent formulas in Fp12 (inversions are cheap via the
    tower, and the Miller loop is only ~70 iterations — the verifier is a
    cold path)."""
    (x1, y1), (x2, y2) = r, q
    (xt, yt) = pt
    if x1 != x2:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    elif y1 == y2:
        three_x1_sq = fp12_mul(fp12_sq(x1), ((( 3, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO))
        lam = fp12_mul(three_x1_sq, fp12_inv(fp12_add(y1, y1)))
    else:
        # vertical line: value = xt - x1, result is infinity — callers in the
        # Miller loop never hit this for valid subgroup points, but handle it.
        return (fp12_sub(xt, x1), None)
    value = fp12_sub(fp12_mul(lam, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    x3 = fp12_sub(fp12_sub(fp12_sq(lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (value, (x3, y3))


def miller_loop(q, p) -> Fp12E:
    """Optimal-ate Miller loop for Q in G2 (twist coords), P in G1.

    Returns the unreduced pairing value f (final exponentiation applied
    separately so products of pairings share one final exp)."""
    if q is None or p is None:
        return FP12_ONE
    qf = _untwist(q)
    pf = _embed_g1(p)
    r = qf
    f = FP12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:  # skip leading 1
        val, r = _line(r, r, pf)
        f = fp12_mul(fp12_sq(f), val)
        if bit == "1":
            val, r = _line(r, qf, pf)
            f = fp12_mul(f, val)
    q1 = _fp12_point_frob(qf)
    nq2 = _fp12_point_neg(_fp12_point_frob(q1))
    val, r = _line(r, q1, pf)
    f = fp12_mul(f, val)
    val, _ = _line(r, nq2, pf)
    f = fp12_mul(f, val)
    return f


_FINAL_EXP = (P**12 - 1) // R


def final_exponentiate(f: Fp12E) -> Fp12E:
    """f^((p^12-1)/r), with the easy part done via conj/inv/frobenius."""
    # easy part: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f1 = fp12_mul(fp12_conj(f), fp12_inv(f))
    f2 = fp12_mul(fp12_frobenius(fp12_frobenius(f1)), f1)
    # hard part: ^((p^4 - p^2 + 1)/r) — plain square-and-multiply (cold path)
    hard = (P**4 - P**2 + 1) // R
    return fp12_pow(f2, hard)


def pairing(q, p) -> Fp12E:
    """Full reduced pairing e(P, Q) with P in G1, Q in G2(twist coords)."""
    return final_exponentiate(miller_loop(q, p))


def multi_pairing_check(pairs: Sequence[Tuple[G1Point, object]]) -> bool:
    """Return True iff prod e(P_i, Q_i) == 1 (one shared final exp)."""
    f = FP12_ONE
    for p, q in pairs:
        f = fp12_mul(f, miller_loop(q, p))
    return final_exponentiate(f) == FP12_ONE
