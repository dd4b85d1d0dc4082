# Copy of zkpoa_tpu/models/gadgets/ecdsa_batch.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Randomized batch ECDSA* verification — the reference's layer-1 scaling
trick (circuits/layer_one.circom:40-49 dispatching BatchECDSAVerifyNoPubkey-
Check from puma314/batch-ecdsa), rebuilt from the math with check-style
foreign-field gadgets:

  * point formulas cost ONE congruence check per equation (lambda-witness
    chord/tangent equations via bigint.ff_check_congruence) instead of the
    canonicalizing ff_mul/ff_div chain (~4.3k constraints per add vs ~7k,
    ~3.3k per double vs ~7k);
  * ONE shared doubling chain for the whole batch: the verification
    equation  A*G + sum_i b_i*P_i - sum_i t^i*R_i == 0  (with A = sum t^i
    u1_i, b_i = t^i u2_i mod n and t a Fiat-Shamir challenge Poseidon-
    derived from all signature registers) is evaluated by one interleaved
    windowed ladder: 64 window steps x (4 shared doubles + one table-mux
    add per term). Incremental cost per signature is two 16-entry tables
    + 128 window adds instead of a full per-signature double chain.

Soundness: t is committed to every input register before use (in-circuit
Fiat-Shamir, 128-bit challenge), so a batch with any invalid signature
verifies with probability <= ~b * 2^-128 over t (standard randomized batch
verification). Exceptional chord cases are excluded by inverse witnesses
(dx != 0 checks); accumulator offsets D/D2_t (nothing-up-my-sleeve hashed-
to-curve constants) keep honest traces away from exceptional cases.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..r1cs import LC, AnyLC, Circuit, Signal, _lc
from . import bigint as B
from .core import num2bits
from .bigint import FF, FFU, FFSpec, ffu, ffu_add, ffu_const, ffu_scale, ffu_sub
from .ec import (
    ECPoint,
    ECSpec,
    SECP256K1_EC,
    _ec_add_host,
    _ec_mul_host,
    _sswu_ish_aux_point,
    ff_bits,
)

WINDOW = 4  # ladder window bits
CHALLENGE_BITS = 128  # Fiat-Shamir challenge size


# ---------------------------------------------------------------------------
# Check-style point operations (lambda witnessing)
# ---------------------------------------------------------------------------


def ec_add_checked(c: Circuit, spec: ECSpec, p1: ECPoint, p2: ECPoint) -> ECPoint:
    """Chord addition via witnessed lambda/x3/y3 and three congruence
    checks. ~3.2k constraints at 64x4.

    CANONICAL-X INVARIANT: both inputs' x-coordinates must be canonical
    (< p) representations — then x1 != x2 (mod p) is proven by the cheap
    limbwise-inequality check instead of a w*(x2-x1)==1 inverse
    congruence (~1.2k constraints saved per add, ~89% of layer-1's
    per-sig constraint slope vs the reference's 447k; README Performance
    notes). The invariant holds inductively: this gadget and
    ec_double_checked canonicalize their x3 output (~n+3k constraints,
    ff_assert_canonical), and every ladder entry point (pubkey, R, H
    witness points) is canonicalized on entry in batch_ecdsa_star_verify.
    Without canonicity a prover could exhibit x2 = x1 + p limbwise (only
    representable when the true coordinate is < 2^256 - p), making dx = 0
    mod p and lambda a free variable."""
    f = spec.field
    p = f.p
    x1v, y1v = p1.x.value % p, p1.y.value % p
    x2v, y2v = p2.x.value % p, p2.y.value % p
    assert x1v != x2v, "ec_add_checked: exceptional case (equal x)"
    assert p1.x.value < p and p2.x.value < p, "ec_add_checked: x not canonical"
    lam_v = (y2v - y1v) * pow(x2v - x1v, -1, p) % p
    x3v = (lam_v * lam_v - x1v - x2v) % p
    y3v = (lam_v * (x1v - x3v) - y1v) % p

    lam = B.ff_witness(c, f, lam_v)
    x3 = B.ff_witness(c, f, x3v)
    y3 = B.ff_witness(c, f, y3v)

    # x1 != x2 (mod p): limbwise inequality on canonical operands
    B.ff_assert_limbs_differ(c, p1.x, p2.x)
    dx = ffu_sub(ffu(p2.x), ffu(p1.x))
    dy = ffu_sub(ffu(p2.y), ffu(p1.y))
    # lam * dx == dy
    B.ff_check_congruence(c, f, [(lam, dx, 1)], dy, lin_sign=-1)
    # lam^2 == x1 + x2 + x3
    rhs = ffu_add(ffu_add(ffu(p1.x), ffu(p2.x)), ffu(x3))
    B.ff_check_congruence(c, f, [(lam, lam, 1)], rhs, lin_sign=-1)
    # lam * (x1 - x3) == y1 + y3
    dx13 = ffu_sub(ffu(p1.x), ffu(x3))
    B.ff_check_congruence(
        c, f, [(lam, dx13, 1)], ffu_add(ffu(p1.y), ffu(y3)), lin_sign=-1
    )
    # maintain the invariant for the next add in the chain
    B.ff_assert_canonical(c, x3)
    return ECPoint(x3, y3)


def ec_double_checked(c: Circuit, spec: ECSpec, p1: ECPoint) -> ECPoint:
    """Tangent doubling via witnessed lambda: 2y*lam == 3x^2 (+a), then the
    same x3/y3 checks. ~3.3k constraints at 64x4. No 2y != 0 check needed
    on a prime-odd-order curve (see ec.ec_double)."""
    f = spec.field
    p = f.p
    xv, yv = p1.x.value % p, p1.y.value % p
    lam_v = (3 * xv * xv + spec.a) * pow(2 * yv, -1, p) % p
    x3v = (lam_v * lam_v - 2 * xv) % p
    y3v = (lam_v * (xv - x3v) - yv) % p

    lam = B.ff_witness(c, f, lam_v)
    x3 = B.ff_witness(c, f, x3v)
    y3 = B.ff_witness(c, f, y3v)

    two_y = ffu_scale(ffu(p1.y), 2)
    lin = ffu_const(f, spec.a) if spec.a else None
    prods = [(lam, two_y, 1), (p1.x, p1.x, -3)]
    if lin is not None:
        B.ff_check_congruence(c, f, prods, lin, lin_sign=-1)
    else:
        B.ff_check_congruence(c, f, prods, None)
    rhs = ffu_add(ffu_scale(ffu(p1.x), 2), ffu(x3))
    B.ff_check_congruence(c, f, [(lam, lam, 1)], rhs, lin_sign=-1)
    dx13 = ffu_sub(ffu(p1.x), ffu(x3))
    B.ff_check_congruence(
        c, f, [(lam, dx13, 1)], ffu_add(ffu(p1.y), ffu(y3)), lin_sign=-1
    )
    # canonical-x invariant for the downstream chord add (see
    # ec_add_checked)
    B.ff_assert_canonical(c, x3)
    return ECPoint(x3, y3)


def ec_on_curve_checked(c: Circuit, spec: ECSpec, pt: ECPoint) -> None:
    """y^2 == x^3 + a x + b via one squared witness + two checks."""
    f = spec.field
    p = f.p
    xv = pt.x.value % p
    xx = B.ff_witness(c, f, xv * xv % p)
    B.ff_check_congruence(c, f, [(pt.x, pt.x, 1)], ffu(xx), lin_sign=-1)
    # xx * x + a*x + b - y^2 == 0
    lin = ffu_const(f, spec.b)
    if spec.a:
        lin = ffu_add(lin, ffu_scale(ffu(pt.x), spec.a))
    B.ff_check_congruence(
        c, f, [(xx, pt.x, 1), (pt.y, pt.y, -1)], lin, lin_sign=1
    )


def ec_assert_equal(c: Circuit, spec: ECSpec, p1: ECPoint, p2: ECPoint) -> None:
    """x1 == x2 and y1 == y2 mod p via two congruence checks (handles
    non-canonical limb representations)."""
    f = spec.field
    one = B.ff_const(c, f, 1)
    B.ff_check_congruence(
        c, f, [(one, ffu_sub(ffu(p1.x), ffu(p2.x)), 1)], None
    )
    B.ff_check_congruence(
        c, f, [(one, ffu_sub(ffu(p1.y), ffu(p2.y)), 1)], None
    )


# ---------------------------------------------------------------------------
# Window mux
# ---------------------------------------------------------------------------


def mux_points(
    c: Circuit, spec: ECSpec, onehot: Sequence[LC], table: Sequence[ECPoint],
    sel_value: int,
) -> ECPoint:
    """Select table[sel_value] with one-hot coefficients. Constant-table
    entries cost nothing (linear); witness tables cost one mul per
    (entry, limb)."""
    f = spec.field
    k = f.k

    def mux_coord(get):
        limbs: List[LC] = []
        for li in range(k):
            acc = LC.const(0)
            for j, e in enumerate(onehot):
                limb = get(table[j])[li]
                if isinstance(limb, LC) and len(limb.terms) == 1 and 0 in limb.terms:
                    acc = acc + e * limb.terms[0]  # constant entry: linear
                elif isinstance(limb, LC) and not limb.terms:
                    pass  # zero limb
                else:
                    acc = acc + _lc(c.mul(e, limb))
            limbs.append(acc)
        return limbs

    xv, yv = table[sel_value].x.value, table[sel_value].y.value
    x = FF(f, mux_coord(lambda t: t.x.limbs), xv)
    y = FF(f, mux_coord(lambda t: t.y.limbs), yv)
    return ECPoint(x, y)


# ---------------------------------------------------------------------------
# Signed-odd-window ladder: nonzero digits, half-size tables.
#
# Scalars are recoded to base-16 digits d_j that are ODD and NONZERO
# (d_j in {+-1, +-3, ..., +-15}), so a window table needs only the 8 odd
# multiples {1,3,...,15}*B (one double + 7 adds, vs 15 adds for the
# unsigned 16-entry j*B + D2 table) and the D2 offset machinery vanishes
# (no zero digit to paper over). The sign applies INSIDE the window as a
# linear y-negation (limbs p_i - y_i, one select mul per limb). Odd-only
# digits exist exactly for ODD scalars; the two scalar sources handle
# parity differently:
#   * 256-bit b_i terms: s' = b_i + (1 - parity)*n — n*P = O on secp256k1
#     (P has group order n), so s'*P == b_i*P exactly;
#   * 128-bit challenge terms t_i on base R: t_i*R = (2t_i + 1)*H - H with
#     H = (1/2 mod n)*R witnessed and checked by one doubling (2H == R);
#     2t_i + 1 is odd by construction and H joins the final sum once.
# ---------------------------------------------------------------------------


def onehot8(c: Circuit, bits: Sequence[AnyLC]) -> List[LC]:
    """One-hot of a 3-bit value: 9 mul constraints (vs 18 for 4 bits)."""
    b0, b1, b2 = (_lc(b) for b in bits)
    m01 = _lc(c.mul(b0, b1))
    pair = [1 - b0 - b1 + m01, b0 - m01, b1 - m01, m01]
    out = []
    for j in range(8):
        hi = b2 if j >= 4 else (1 - b2)
        out.append(_lc(c.mul(pair[j & 3], hi)))
    return out


def _recode_signed_odd(v: int, n_windows: int) -> List[int]:
    """v ODD -> n_windows base-16 digits, each odd in [-15, 15], with
    v == sum_j d_j 16^j. Chooses d_j in {u, u-16} (u = v mod 16, odd) so
    every partial quotient stays odd; the final digit is the remaining
    quotient itself (|.| <= 15 when n_windows covers bitlen(v)/4 + 1)."""
    assert v & 1, "signed-odd recoding needs an odd scalar"
    digs: List[int] = []
    for _ in range(n_windows - 1):
        u = v & 15
        q0 = (v - u) >> 4
        d = u if (q0 & 1) else u - 16
        digs.append(d)
        v = (v - d) >> 4
    assert v & 1 and -15 <= v <= 15, f"recoding tail {v} out of range"
    digs.append(v)
    return digs


class SignedTerm:
    """One signed-ladder term: per-window magnitude bits m (|d| = 2m+1),
    sign bits s (d < 0), the 8-point odd-multiple table, and a flip flag
    (term enters the sum negated — digit signs read inverted)."""

    __slots__ = ("mbits", "sbits", "mvals", "svals", "table", "n_windows",
                 "flip")

    def __init__(self, mbits, sbits, mvals, svals, table, flip=False):
        self.mbits = mbits
        self.sbits = sbits
        self.mvals = mvals
        self.svals = svals
        self.table = table
        self.n_windows = len(mvals)
        self.flip = flip


def _alloc_digits(c: Circuit, dvals: Sequence[int]):
    """Allocate digit witnesses: 3 magnitude bits + 1 sign bit per window.
    Returns (mbits, sbits, mvals, svals, digit LCs) with
    d = (1 + 2m)(1 - 2s) — one mul constraint per window."""
    mbits, sbits, mvals, svals, dlcs = [], [], [], [], []
    for d in dvals:
        s = 1 if d < 0 else 0
        m = (abs(d) - 1) // 2
        m_sig = c.var(m)
        mb = num2bits(c, m_sig, 3)
        s_sig = c.var(s)
        sb = num2bits(c, s_sig, 1)[0]
        mag = _lc(m_sig) * 2 + 1
        d_lc = mag - _lc(c.mul(s_sig, mag)) * 2
        mbits.append(mb)
        sbits.append(_lc(sb))
        mvals.append(m)
        svals.append(s)
        dlcs.append(d_lc)
    return mbits, sbits, mvals, svals, dlcs


def _bind_digits(c: Circuit, spec_ff, dlcs, dvals, rhs_limbs, rhs_vals):
    """Exact integer identity sum_j d_j 16^j == sum_t rhs_t 2^(n t), via
    the shared signed carry chain (bigint.assert_limb_poly_zero)."""
    wpl = spec_ff.n // WINDOW  # windows per limb column
    ncols = max((len(dlcs) + wpl - 1) // wpl, len(rhs_limbs)) + 1
    cols, vals = [], []
    for t in range(ncols):
        col = LC.const(0)
        cv = 0
        for j in range(t * wpl, min((t + 1) * wpl, len(dlcs))):
            sh = 1 << (WINDOW * (j - t * wpl))
            col = col + dlcs[j] * sh
            cv += dvals[j] * sh
        if t < len(rhs_limbs):
            col = col - rhs_limbs[t]
            cv -= rhs_vals[t]
        cols.append(col)
        vals.append(cv)
    B.assert_limb_poly_zero(c, cols, vals, spec_ff)


def _signed_table_const(c: Circuit, spec: ECSpec, base: Tuple[int, int]):
    from .ec import ec_const

    pts, acc = [], base
    dbl = _ec_add_host(spec, base, base)
    for m in range(8):
        pts.append(ec_const(c, spec, acc))
        if m < 7:
            acc = _ec_add_host(spec, acc, dbl)
    return pts


def _signed_table_witness(c: Circuit, spec: ECSpec, base: ECPoint):
    b2 = ec_double_checked(c, spec, base)
    table = [base]
    for _ in range(7):
        table.append(ec_add_checked(c, spec, table[-1], b2))
    return table


def make_signed_term_ff(c: Circuit, spec: ECSpec, x: FF, base, tag: str,
                        witness_base: bool, n_windows: int = 65,
                        flip: bool = False) -> SignedTerm:
    """Term for a full-width (<= 2^(4(L-1))) scalar given as an FF over the
    GROUP ORDER field: digits encode s' = x + (1 - parity)*n, which scales
    any order-n base identically to x."""
    fr = x.spec
    p0v = x.value & 1
    p0 = c.var(p0v)
    num2bits(c, p0, 1)
    sp = x.value + (0 if p0v else fr.p)
    dvals = _recode_signed_odd(sp, n_windows)
    mbits, sbits, mvals, svals, dlcs = _alloc_digits(c, dvals)
    # raw radix-2^n limbs of the modulus itself (to_limbs reduces mod p)
    n_limbs_c = [(fr.p >> (fr.n * t)) & ((1 << fr.n) - 1) for t in range(fr.k)]
    rhs = [x.limbs[t] + (1 - _lc(p0)) * int(n_limbs_c[t]) for t in range(fr.k)]
    rhs_v = [(x.value >> (fr.n * t)) & ((1 << fr.n) - 1) for t in range(fr.k)]
    rhs_v = [rv + (0 if p0v else int(n_limbs_c[t])) for t, rv in enumerate(rhs_v)]
    _bind_digits(c, fr, dlcs, dvals, rhs, rhs_v)
    table = (_signed_table_witness(c, spec, base) if witness_base
             else _signed_table_const(c, spec, base))
    return SignedTerm(mbits, sbits, mvals, svals, table, flip=flip)


def make_signed_term_odd_scalar(c: Circuit, spec_ff, spec: ECSpec,
                                scalar_limbs: Sequence[LC],
                                scalar_limb_vals: Sequence[int],
                                scalar_val: int,
                                base: ECPoint, tag: str, n_windows: int,
                                flip: bool = False) -> SignedTerm:
    """Term for an already-ODD scalar given as limb LCs (e.g. 2t+1 from a
    Fiat-Shamir challenge): digits bind directly to the limbs.
    scalar_limb_vals are the exact LC values (limbs of 2t+1 may exceed
    2^n — the carry chain absorbs that; masking scalar_val would misstate
    the witness)."""
    dvals = _recode_signed_odd(scalar_val, n_windows)
    mbits, sbits, mvals, svals, dlcs = _alloc_digits(c, dvals)
    assert sum(int(v) << (spec_ff.n * t)
               for t, v in enumerate(scalar_limb_vals)) == scalar_val
    _bind_digits(c, spec_ff, dlcs, dvals, list(scalar_limbs),
                 [int(v) for v in scalar_limb_vals])
    table = _signed_table_witness(c, spec, base)
    return SignedTerm(mbits, sbits, mvals, svals, table, flip=flip)


def _signed_mux_add(c: Circuit, spec: ECSpec, acc: ECPoint, t: SignedTerm,
                    w: int) -> ECPoint:
    """One window: 8-entry magnitude mux, linear sign negation of y
    (y' = y + s*(p - 2y) limbwise), then the checked chord add."""
    f = spec.field
    oh = onehot8(c, t.mbits[w])
    e = mux_points(c, spec, oh, t.table, t.mvals[w])
    s_lc = (1 - t.sbits[w]) if t.flip else t.sbits[w]
    s_v = (1 - t.svals[w]) if t.flip else t.svals[w]
    # raw radix limbs of p (to_limbs reduces mod p -> zeros)
    p_limbs = [(f.p >> (f.n * i)) & ((1 << f.n) - 1) for i in range(f.k)]
    y_limbs = [
        e.y.limbs[i] + _lc(c.mul(s_lc, int(p_limbs[i]) - e.y.limbs[i] * 2))
        for i in range(f.k)
    ]
    y_val = (f.p - e.y.value % f.p) % f.p if s_v else e.y.value
    e_signed = ECPoint(e.x, FF(f, y_limbs, y_val))
    return ec_add_checked(c, spec, acc, e_signed)


def signed_msm_ladder(c: Circuit, spec: ECSpec, terms: Sequence[SignedTerm],
                      tag: str = "sladder") -> Tuple[ECPoint, Tuple[int, int]]:
    """sum_t (+-)scalar_t * Base_t + OFFSET via the shared doubling chain;
    every window of every term adds (digits are nonzero), short terms join
    only their low windows. OFFSET = 2^(4 L_max) * D for the hashed-to-
    curve initial accumulator D."""
    from .ec import ec_const

    l_max = max(t.n_windows for t in terms)
    d = _sswu_ish_aux_point(spec, f"batch|{tag}|D")
    acc = ec_const(c, spec, d)
    for w in range(l_max - 1, -1, -1):
        for _ in range(WINDOW):
            acc = ec_double_checked(c, spec, acc)
        for t in terms:
            if w >= t.n_windows:
                continue
            acc = _signed_mux_add(c, spec, acc, t, w)
    off = _ec_mul_host(spec, d, 1 << (WINDOW * l_max))
    return acc, off


# ---------------------------------------------------------------------------
# Batch ECDSA* verification
# ---------------------------------------------------------------------------


def batch_ecdsa_star_verify(
    c: Circuit,
    sigs: Sequence[dict],
    tag: str = "batch",
) -> None:
    """Verify b ECDSA* signatures with one randomized batch equation.

    Each sig dict: {"r": FF(fr), "rprime": FF(fq), "s": FF(fr),
    "msghash": FF(fr), "pubkey": ECPoint}. For b == 1 falls back to the
    direct equation (no challenge needed):  u1 G + u2 P == R.

    Batch equation (b >= 2):
        (sum_i t^i u1_i) G + sum_i (t^i u2_i) P_i + sum_i t^i (-R_i) == 0
    with u1 = m/s, u2 = r/s mod n and t a 128-bit in-circuit Poseidon
    challenge over every input register."""
    from .poseidon_gadget import poseidon_sponge
    from .core import num2bits

    spec = SECP256K1_EC
    f = spec.field
    fr = B.SECP_FR
    b = len(sigs)
    assert b >= 1

    # on-curve checks for every pubkey and every R = (r, rprime)
    r_points: List[ECPoint] = []
    for sig in sigs:
        ec_on_curve_checked(c, spec, sig["pubkey"])
        # canonical-x invariant for every point entering a checked chord
        # add (see ec_add_checked): pubkey and R are prover inputs
        B.ff_assert_canonical(c, sig["pubkey"].x)
        r_ff_q = FF(f, sig["r"].limbs, sig["r"].value)  # r < n < p: same limbs
        B.ff_assert_canonical(c, r_ff_q)
        r_pt = ECPoint(r_ff_q, sig["rprime"])
        ec_on_curve_checked(c, spec, r_pt)
        r_points.append(r_pt)

    # u1_i = m/s, u2_i = r/s (mod n) with bit decompositions
    u1s: List[FF] = []
    u2s: List[FF] = []
    for i, sig in enumerate(sigs):
        s, m, r = sig["s"], sig["msghash"], sig["r"]
        sinv_val = pow(s.value, -1, fr.p)
        sinv = B.ff_witness(c, fr, sinv_val)
        B.ff_check_congruence(c, fr, [(s, sinv, 1)], ffu_const(fr, 1), lin_sign=-1)
        u1 = B.ff_witness(c, fr, m.value * sinv_val % fr.p)
        u2 = B.ff_witness(c, fr, r.value * sinv_val % fr.p)
        B.ff_check_congruence(c, fr, [(m, sinv, 1)], ffu(u1), lin_sign=-1)
        B.ff_check_congruence(c, fr, [(r, sinv, 1)], ffu(u2), lin_sign=-1)
        u1s.append(u1)
        u2s.append(u2)

    if b == 1:
        terms = [
            make_signed_term_ff(c, spec, u1s[0], spec.gen, f"{tag}|G",
                                witness_base=False),
            make_signed_term_ff(c, spec, u2s[0], sigs[0]["pubkey"],
                                f"{tag}|P0", witness_base=True),
        ]
        acc, off = signed_msm_ladder(c, spec, terms, tag=tag)
        # acc == R + off
        target = _ec_add_host(spec, (r_points[0].x.value, r_points[0].y.value), off)
        rhs = ec_add_checked(
            c, spec, r_points[0],
            ECPoint(B.ff_const(c, f, off[0]), B.ff_const(c, f, off[1])),
        )
        assert (rhs.x.value % f.p, rhs.y.value % f.p) == target
        ec_assert_equal(c, spec, acc, rhs)
        return

    # --- Fiat-Shamir challenges over every input register ----------------
    # INDEPENDENT 128-bit challenges t_i per signature (t_0 = 1) instead
    # of powers of one challenge: the soundness argument is the same
    # (any single defect survives a random independent combination with
    # probability <= 2^-128), and a 128-bit ladder scalar joins only the
    # low half of the windows — the -R_i terms drop from 64 to 32
    # mux-adds each (~146k constraints/sig saved vs the t^i scheme).
    absorb: List[AnyLC] = []
    for sig in sigs:
        for ffel in (sig["r"], sig["rprime"], sig["s"], sig["msghash"]):
            absorb.extend(ffel.limbs)
        absorb.extend(sig["pubkey"].x.limbs)
        absorb.extend(sig["pubkey"].y.limbs)
    h = poseidon_sponge(c, absorb)

    def challenge_from(h_lc) -> FF:
        """Low 128 bits of h as an FF over Fr (bits boolean-constrained by
        num2bits; the truncation binds through the bit LCs)."""
        h_val = c.eval_lc(h_lc)
        h_bits = num2bits(c, h_lc, 254)
        t_val = h_val & ((1 << CHALLENGE_BITS) - 1)
        t_limbs: List[LC] = []
        for li in range(fr.k):
            acc_lc = LC.const(0)
            for bi_ in range(fr.n):
                idx = li * fr.n + bi_
                if idx < CHALLENGE_BITS:
                    acc_lc = acc_lc + _lc(h_bits[idx]) * (1 << bi_)
            t_limbs.append(acc_lc)
        return FF(fr, t_limbs, t_val)

    # challenge chain: h_1 = h, h_{i+1} = Poseidon(h_i) — each yields the
    # low 128 bits (domain-separated by position in the chain)
    t_chall: List[Optional[FF]] = [None] * b
    h_cur = h
    for i in range(1, b):
        t_chall[i] = challenge_from(h_cur)
        if i + 1 < b:
            h_cur = poseidon_sponge(c, [h_cur])

    a_terms: List[FF] = [u1s[0]]
    b_terms: List[FF] = [u2s[0]]
    for i in range(1, b):
        ti = t_chall[i]
        av = ti.value * u1s[i].value % fr.p
        bv = ti.value * u2s[i].value % fr.p
        ai = B.ff_witness(c, fr, av)
        bi = B.ff_witness(c, fr, bv)
        B.ff_check_congruence(c, fr, [(ti, u1s[i], 1)], ffu(ai), lin_sign=-1)
        B.ff_check_congruence(c, fr, [(ti, u2s[i], 1)], ffu(bi), lin_sign=-1)
        a_terms.append(ai)
        b_terms.append(bi)

    # A = sum a_i mod n. Any 256-bit representative of A mod n is sound:
    # the ladder scalar acts on G, whose order IS n, so A·G only depends
    # on A mod n — one congruence check binds the witness.
    a_sum_val = sum(x.value for x in a_terms)
    A = B.ff_witness(c, fr, a_sum_val % fr.p)
    acc_u = ffu(a_terms[0])
    for x in a_terms[1:]:
        acc_u = ffu_add(acc_u, ffu(x))
    acc_u = ffu_sub(acc_u, ffu(A))
    one_fr = B.ff_const(c, fr, 1)
    B.ff_check_congruence(c, fr, [(one_fr, acc_u, 1)], None)

    # ladder: A*G + sum_i b_i * P_i - sum_{i>=1} t_i * R_i  ==  R_0
    # (R_0 has coefficient t_0 = 1, so it moves to the equality target).
    # The 128-bit challenge terms use the halving trick: t_i * R_i =
    # (2 t_i + 1) * H_i - H_i with H_i = (1/2 mod n) * R_i witnessed and
    # bound by one doubling check — (2t+1) is odd, so the term joins the
    # signed ladder's low 33 windows with a nonzero digit everywhere.
    terms = [make_signed_term_ff(c, spec, A, spec.gen, f"{tag}|G",
                                 witness_base=False)]
    for i in range(b):
        terms.append(
            make_signed_term_ff(c, spec, b_terms[i], sigs[i]["pubkey"],
                                f"{tag}|P{i}", witness_base=True)
        )
    halves: List[ECPoint] = []
    inv2 = pow(2, -1, fr.p)
    for i in range(1, b):
        hv = _ec_mul_host(
            spec, (r_points[i].x.value % f.p, r_points[i].y.value % f.p), inv2)
        h_pt = ECPoint(B.ff_witness(c, f, hv[0]), B.ff_witness(c, f, hv[1]))
        B.ff_assert_canonical(c, h_pt.x)  # ladder-table base (see ec_add_checked)
        ec_on_curve_checked(c, spec, h_pt)
        ec_assert_equal(c, spec, ec_double_checked(c, spec, h_pt), r_points[i])
        halves.append(h_pt)
        # scalar 2t+1: limb LCs double the challenge limbs, +1 on limb 0
        tp_limbs = [t_chall[i].limbs[j] * 2 + (1 if j == 0 else 0)
                    for j in range(fr.k)]
        tmask = (1 << fr.n) - 1
        tp_lvals = [2 * ((t_chall[i].value >> (fr.n * j)) & tmask)
                    + (1 if j == 0 else 0) for j in range(fr.k)]
        tp_val = 2 * t_chall[i].value + 1
        terms.append(
            make_signed_term_odd_scalar(
                c, fr, spec, tp_limbs, tp_lvals, tp_val, h_pt, f"{tag}|R{i}",
                n_windows=(CHALLENGE_BITS + WINDOW) // WINDOW, flip=True,
            )
        )

    acc, off = signed_msm_ladder(c, spec, terms, tag=tag)
    # acc + sum_i H_i == R_0 + off   (the +H_i of every halved R-term)
    for h_pt in halves:
        acc = ec_add_checked(c, spec, acc, h_pt)
    off_pt = ECPoint(B.ff_const(c, f, off[0]), B.ff_const(c, f, off[1]))
    rhs = ec_add_checked(c, spec, r_points[0], off_pt)
    ec_assert_equal(c, spec, acc, rhs)
