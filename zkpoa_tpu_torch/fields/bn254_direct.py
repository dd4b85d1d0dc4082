# Copy of zkpoa_tpu/fields/bn254_direct.py; only its imports are rewritten for zkpoa_tpu_torch.
"""BN254 Fp12 in the direct polynomial basis + residue-witness machinery.

Host-side support for the in-snark Groth16 verifier gadget
(models/gadgets/pairing_gadget.py) — the framework's equivalent of the
reference's vendored circom-pairing verifyProof (~19.5M constraints;
SURVEY.md §2.2, circuits/layer_two.circom:44-49, layer_three.circom:41-48).
Our gadget is ~3x smaller because of three design choices prepared here:

1. **Direct basis.** Fp12 = Fp[w]/(w^12 - 18 w^6 + 82) instead of the
   2-3-2 tower (with u = w^6 - 9, xi = 9 + u this is the same field:
   (w^6-9)^2 = u^2 = -1). A full in-circuit Fp12 mul then needs only 12
   foreign-field reductions (one per output coefficient) with all cross
   products folded into a single carry chain each.

2. **Affine Miller loop with precomputed lines.** The Groth16 check
   pairs (B, -A), (gamma2, vk_x), (delta2, C): gamma2/delta2 are circuit
   constants, so their entire Miller line sequences are precomputed here
   on the host; in-circuit their line values are *linear* in the two
   per-G1-point signals (-x/y, 1/y).

3. **Residue witness instead of a final exponentiation** (the technique
   of Novakovic & Eagen, "On Proving Pairings", re-derived from first
   principles below): FE(F) == 1 iff there exist c in Fp12* and u in
   mu_27 (the 3-Sylow subgroup; v_3(p^12-1) = 3) with F * u == c^lambda,
   lambda = 6x+2 + p - p^2 + p^3.  c^(6x+2) folds into the Miller loop's
   square-and-multiply for free; c^(p^k) are Frobenius maps (linear).
   This removes the entire hard+easy final exponentiation from the
   circuit.  Soundness: lambda = r*m with FE(c^lambda) = c^(m*(p^12-1))
   = 1 and FE(u) = u^h = 1 (27 | h), so F*u = c^lambda forces FE(F) = 1.

Everything here is exact host integer math; the gadget mirrors the same
operation sequence so its eagerly-computed witness values coincide with
these functions' outputs.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from . import bn254 as bn
from .bn254 import (
    ATE_LOOP_COUNT,
    FP2_ONE,
    FP12_ONE,
    P,
    R,
    X_PARAM,
    fp2_add,
    fp2_conj,
    fp2_inv,
    fp2_mul,
    fp2_neg,
    fp2_pow,
    fp2_sq,
    fp2_sub,
    fp12_conj,
    fp12_frobenius,
    fp12_inv,
    fp12_mul,
    fp12_pow,
    fp12_sq,
)

Fp2E = Tuple[int, int]
Fp12E = Tuple[Tuple[Fp2E, Fp2E, Fp2E], Tuple[Fp2E, Fp2E, Fp2E]]

# --------------------------------------------------------------------------
# Direct basis <-> tower basis
#
# Tower layout (fields/bn254.py): ((c0, c2, c4), (c1, c3, c5)) with
# element = sum_i c_i w^i, c_i = x_i + y_i*u in Fp2, u = w^6 - 9.
# Direct: d[k] for k < 12 with element = sum_k d_k w^k:
#   d_i     = x_i - 9*y_i      (i < 6)
#   d_{i+6} = y_i
# --------------------------------------------------------------------------


def tower_to_direct(a: Fp12E) -> Tuple[int, ...]:
    (c0, c2, c4), (c1, c3, c5) = a
    cs = (c0, c1, c2, c3, c4, c5)
    d = [0] * 12
    for i, (x, y) in enumerate(cs):
        d[i] = (x - 9 * y) % P
        d[i + 6] = y % P
    return tuple(d)


def direct_to_tower(d: Sequence[int]) -> Fp12E:
    cs = []
    for i in range(6):
        y = d[i + 6] % P
        x = (d[i] + 9 * y) % P
        cs.append((x, y))
    c0, c1, c2, c3, c4, c5 = cs
    return ((c0, c2, c4), (c1, c3, c5))


# Reduction: w^12 = 18 w^6 - 82. Degrees 12..22 fold as
#   w^(12+j) = 18 w^(6+j) - 82 w^j            (j < 6)
# (no double reduction needed: 12+j <= 17 for the first fold target 6+j<12).
REDUCTION_HI_COEFF = 18  # coefficient on w^(k-6)
REDUCTION_LO_COEFF = -82  # coefficient on w^(k-12)


def direct_mul(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    """Schoolbook direct-basis product (host mirror of the gadget op)."""
    raw = [0] * 23
    for i in range(12):
        if not a[i]:
            continue
        for j in range(12):
            raw[i + j] += a[i] * b[j]
    d = list(raw[:12])
    for k in range(22, 11, -1):
        v = raw[k]
        if not v:
            continue
        raw[k - 6] += 18 * v
        raw[k - 12] -= 82 * v
        raw[k] = 0
        if k - 6 >= 12:
            # cascades handled because we iterate downward
            pass
    d = [raw[i] % P for i in range(12)]
    return tuple(d)


# --------------------------------------------------------------------------
# NAF of the ate loop count 6x+2, and G2 Frobenius (psi) constants
# --------------------------------------------------------------------------


def naf(k: int) -> List[int]:
    """Non-adjacent form, least-significant digit first."""
    out = []
    while k:
        if k & 1:
            d = 2 - (k % 4)
            out.append(d)
            k -= d
        else:
            out.append(0)
        k >>= 1
    return out


ATE_NAF = naf(ATE_LOOP_COUNT)  # 66 digits, weight 22

# psi(x, y) = (conj(x)*G12, conj(y)*G13): untwist-frobenius-twist constants
G12: Fp2E = fp2_pow(bn.XI, (P - 1) // 3)
G13: Fp2E = fp2_pow(bn.XI, (P - 1) // 2)


def g2_frobenius(q):
    x, y = q
    return (fp2_mul(fp2_conj(x), G12), fp2_mul(fp2_conj(y), G13))


def g2_neg(q):
    x, y = q
    return (x, fp2_neg(y))


# --------------------------------------------------------------------------
# Affine Miller loop with 034-sparse lines
#
# Line through (twisted) T with slope lam, evaluated at P=(xP,yP) in G1 and
# normalized by 1/yP (an Fp* factor, killed by the final exponentiation):
#   l(P) = 1 + lam*(-xP/yP) * w + (lam*x_T - y_T)*(1/yP) * w^3
# Sparse tower slots: (w^0, w^1, w^3) -> the classic c0/c3/c4 "034" shape.
# --------------------------------------------------------------------------


def _affine_double(t):
    """Return (2T, lam)."""
    x, y = t
    lam = fp2_mul(
        fp2_mul(fp2_sq(x), (3, 0)),
        fp2_inv(fp2_mul(y, (2, 0))),
    )
    x3 = fp2_sub(fp2_sq(lam), fp2_mul(x, (2, 0)))
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x, x3)), y)
    return (x3, y3), lam


def _affine_add(t, q):
    """Return (T+Q, lam). Assumes x_T != x_Q (generic position)."""
    x1, y1 = t
    x2, y2 = q
    lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sq(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3), lam


def precompute_g2_lines(q) -> List[Tuple[Fp2E, Fp2E]]:
    """Fixed-Q line coefficients (c_w, c_w3) for every Miller event, in
    exact loop order: per NAF digit one doubling line (+ one addition line
    when the digit is nonzero), then the two Frobenius end lines."""
    out = []
    t = q
    for digit in reversed(ATE_NAF[:-1]):
        (t2, lam) = _affine_double(t)
        out.append((lam, fp2_sub(fp2_mul(lam, t[0]), t[1])))
        t = t2
        if digit:
            q_eff = q if digit == 1 else g2_neg(q)
            (t2, lam) = _affine_add(t, q_eff)
            out.append((lam, fp2_sub(fp2_mul(lam, t[0]), t[1])))
            t = t2
    q1 = g2_frobenius(q)
    q2 = g2_neg(g2_frobenius(q1))
    (t2, lam) = _affine_add(t, q1)
    out.append((lam, fp2_sub(fp2_mul(lam, t[0]), t[1])))
    t = t2
    (t2, lam) = _affine_add(t, q2)
    out.append((lam, fp2_sub(fp2_mul(lam, t[0]), t[1])))
    return out


def line_value(coeffs: Tuple[Fp2E, Fp2E], x_over_y_neg: int, y_inv: int) -> Fp12E:
    """Evaluate a line with coefficients (c_w, c_w3) at precomputed
    -xP/yP and 1/yP. Result is an 034-sparse Fp12 (tower form)."""
    c_w, c_w3 = coeffs
    l_w = fp2_mul(c_w, (x_over_y_neg, 0))
    l_w3 = fp2_mul(c_w3, (y_inv, 0))
    zero = (0, 0)
    return ((FP2_ONE, zero, zero), (l_w, l_w3, zero))


def multi_miller_affine(pairs) -> Fp12E:
    """Product of Miller loops over [(Q_i, P_i)] with shared squarings —
    the exact value (tower form) the in-circuit loop computes (without the
    residue-witness injection). Affine, NAF, 1/yP-normalized lines."""
    lines = [precompute_g2_lines(q) for q, _ in pairs]
    evals = []
    for (q, p) in pairs:
        xp, yp = p
        y_inv = pow(yp, -1, P)
        evals.append(((-xp * y_inv) % P, y_inv))
    idx = [0] * len(pairs)

    f = FP12_ONE
    for digit in reversed(ATE_NAF[:-1]):
        f = fp12_sq(f)
        for i in range(len(pairs)):
            f = fp12_mul(f, line_value(lines[i][idx[i]], *evals[i]))
            idx[i] += 1
        if digit:
            for i in range(len(pairs)):
                f = fp12_mul(f, line_value(lines[i][idx[i]], *evals[i]))
                idx[i] += 1
    for _ in range(2):
        for i in range(len(pairs)):
            f = fp12_mul(f, line_value(lines[i][idx[i]], *evals[i]))
            idx[i] += 1
    return f


# --------------------------------------------------------------------------
# Residue witness (final-exponentiation elimination)
# --------------------------------------------------------------------------

LAMBDA = 6 * X_PARAM + 2 + P - P**2 + P**3
N_ORDER = P**12 - 1
H_COFACTOR = N_ORDER // R
assert LAMBDA % R == 0
M_SCALE = LAMBDA // R
assert math.gcd(M_SCALE, H_COFACTOR) == 3  # the only obstruction is mu_27

# sigma: FE(z^sigma) = z for z in mu_r (used to lift the reference's
# post-FE negalfa1xbeta2 constant to a pre-FE representative).
SIGMA = pow(H_COFACTOR % R, -1, R)

_W27 = None
_EXP_C = None
_W27_POWS = None


def _find_w27() -> Fp12E:
    """Deterministic generator of mu_27 (v_3(p^12-1) = 3)."""
    exp = N_ORDER // 27
    k = 2
    while True:
        # candidate: (k + w) in tower form — generic enough to hit full order
        cand: Fp12E = ((((k, 0), (0, 0), (0, 0))), (((1, 0), (0, 0), (0, 0))))
        w = fp12_pow(cand, exp)
        if fp12_pow(w, 9) != FP12_ONE:
            return w
        k += 1


def w27() -> Fp12E:
    global _W27, _W27_POWS
    if _W27 is None:
        _W27 = _find_w27()
        pows = [FP12_ONE]
        for _ in range(26):
            pows.append(fp12_mul(pows[-1], _W27))
        _W27_POWS = pows
    return _W27


def w27_powers() -> List[Fp12E]:
    w27()
    return _W27_POWS


def _exp_c() -> int:
    """Fixed exponent E with z^E a candidate lambda-th root (up to mu_9,
    fixed by a w27 power): E = lambda^{-1} mod N/(27 r)."""
    global _EXP_C
    if _EXP_C is None:
        n_pp = N_ORDER // (27 * R)
        assert math.gcd(LAMBDA, n_pp) == 1
        _EXP_C = pow(LAMBDA, -1, n_pp)
    return _EXP_C


def residue_witness(f: Fp12E) -> Tuple[Fp12E, int]:
    """Given F with FE(F) == 1, return (c, u_idx) with
    F * w27^u_idx == c^LAMBDA. Raises ValueError if FE(F) != 1 (i.e. the
    pairing check fails)."""
    pows = w27_powers()
    # u: cancel F's mu_27 obstruction — need (F*u)^(h/3) == 1
    h3 = H_COFACTOR // 3
    probe = fp12_pow(f, h3)
    u_idx = None
    for i in range(27):
        if fp12_mul(probe, fp12_pow(pows[i], h3)) == FP12_ONE:
            u_idx = i
            break
    if u_idx is None:
        raise ValueError("pairing check fails: no mu_27 shift makes F a residue")
    z = fp12_mul(f, pows[u_idx])
    # c0 = z^E satisfies c0^lambda = z * (mu_9 junk); fix with a w27 power
    c0 = fp12_pow(z, _exp_c())
    junk = fp12_mul(fp12_pow(c0, LAMBDA), fp12_inv(z))
    w_lam = fp12_pow(w27(), LAMBDA)  # order 9
    cand = FP12_ONE
    for i in range(27):
        if fp12_mul(junk, fp12_pow(w_lam, i)) == FP12_ONE:
            c = fp12_mul(c0, fp12_pow(w27(), i))
            assert fp12_pow(c, LAMBDA) == z
            return c, u_idx
        cand = fp12_mul(cand, w_lam)
    raise ValueError("residue extraction failed (unexpected)")


def prefe_representative(z_mu_r: Fp12E) -> Fp12E:
    """X with FE(X) == z, for z in mu_r (e.g. the sanitized e(-alpha,beta)
    constant, scripts/sanitize_groth16_proof.py:39-72 in the reference)."""
    return fp12_pow(z_mu_r, SIGMA)
