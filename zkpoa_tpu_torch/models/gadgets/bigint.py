# Copy of zkpoa_tpu/models/gadgets/bigint.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Foreign-field ("bigint") arithmetic gadgets over the native BN254 Fr.

The constraint-side equivalent of the reference's vendored bigint circuit
libraries (circom-ecdsa's bigint.circom for secp256k1 64x4 registers,
circom-pairing's 43x6 BN254 registers — SURVEY.md §2.2): arithmetic in a
foreign prime field p_f is expressed over k limbs of n bits, with products
proven by the witness-quotient identity  a*b = q*p_f + r  checked as a limb
polynomial with a signed carry chain (the CheckCarryToZero pattern,
re-derived; no reference code used).

Limb layouts match the reference's I/O registers (64x4 for secp256k1,
43x6 for BN254-in-circuit, 85x3 for Curve25519 — scripts/lib/field_helper.py
conversions in the reference), so golden input JSON feeds directly.

Soundness invariants:
  * every FF element is range-checked limbwise (< 2^n per limb);
  * products / reductions additionally constrain the result < p_f
    (big_less_than), so equality of elements is limbwise equality;
  * carry bounds: |column_i| <= (k+1)*2^(2n) and carries fit in
    carry_bits = 2n + ceil(log2(k+1)) + 1 - n bits (signed, offset-checked).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ...fields.bn254 import R as P
from ..r1cs import LC, AnyLC, Circuit, Signal, _lc
from .core import num2bits


@dataclass(frozen=True)
class FFSpec:
    """Foreign field layout: prime p, k limbs of n bits (LSB first)."""

    p: int
    n: int
    k: int
    name: str = ""

    def __post_init__(self):
        assert self.p < (1 << (self.n * self.k))
        # native-field headroom for one column of products + carry
        assert 2 * self.n + (self.k + 2).bit_length() + 2 < 253

    def to_limbs(self, x: int) -> List[int]:
        x = int(x) % self.p
        return [(x >> (self.n * i)) & ((1 << self.n) - 1) for i in range(self.k)]

    def from_limbs(self, limbs: Sequence[int]) -> int:
        v = 0
        for i, limb in enumerate(limbs):
            v |= int(limb) << (self.n * i)
        return v


# Reference-compatible layouts
SECP_FQ = None  # initialized below (avoid import cycle at module load)
SECP_FR = None
BN254_FQ_FF = None
ED25519_FQ_FF = None


class FF:
    """A foreign-field element in-circuit: k limb LCs, each range-checked to
    n bits on allocation. `value` is the concrete witness integer."""

    __slots__ = ("spec", "limbs", "value", "bits")

    def __init__(self, spec: FFSpec, limbs: List[AnyLC], value: int, bits=None):
        self.spec = spec
        self.limbs = [_lc(x) for x in limbs]
        self.value = value % (1 << (spec.n * spec.k))
        self.bits = bits  # per-limb bit signals if allocated via witness()


def ff_witness(c: Circuit, spec: FFSpec, value: int, keep_bits: bool = False) -> FF:
    """Allocate a foreign-field element as fresh range-checked limbs."""
    value = int(value)
    assert 0 <= value < (1 << (spec.n * spec.k))
    limbs = []
    all_bits = []
    v = value
    for _ in range(spec.k):
        limb = c.var(v & ((1 << spec.n) - 1))
        bits = num2bits(c, limb, spec.n)
        limbs.append(limb)
        all_bits.append(bits)
        v >>= spec.n
    return FF(spec, limbs, value, bits=all_bits if keep_bits else None)


def ff_const(c: Circuit, spec: FFSpec, value: int) -> FF:
    value = int(value) % spec.p
    return FF(spec, [LC.const(x) for x in spec.to_limbs(value)], value)


def ff_input(c: Circuit, spec: FFSpec, limbs: List[Signal], values: Sequence[int]) -> FF:
    """Wrap existing limb signals (e.g. circuit inputs in the reference's
    64x4 register format) as an FF element, adding the range checks."""
    for limb in limbs:
        num2bits(c, limb, spec.n)
    return FF(spec, list(limbs), spec.from_limbs(values))


def _carry_bits(spec: FFSpec) -> int:
    """Bits needed for the signed carries of a 2-convolution column."""
    return spec.n + (spec.k + 2).bit_length() + 1


def assert_limb_poly_zero(
    c: Circuit,
    cols: List[LC],
    col_vals: List[int],
    spec: FFSpec,
) -> None:
    """Given column LCs t_i (signed values, |t_i| < (k+2)*2^(2n)) whose
    integer evaluation sum_i t_i * 2^(n*i) is 0, constrain exactly that via
    a sequential signed carry chain. col_vals are the concrete *signed*
    column values for witness generation."""
    n = spec.n
    cb = _carry_bits(spec)
    offset = 1 << cb  # carries live in [-2^cb, 2^cb)
    carry_val = 0
    carry_lc: LC = LC.const(0)
    for i in range(len(cols)):
        total_val = col_vals[i] + carry_val
        assert total_val % (1 << n) == 0, "carry chain: column not divisible"
        new_carry = total_val >> n
        if i == len(cols) - 1:
            # last column: carry must be exactly 0
            c.assert_equal(cols[i] + carry_lc, 0)
            assert new_carry == 0, "carry chain: nonzero final carry"
            return
        assert -offset <= new_carry < offset, "carry out of range"
        carry_sig = c.var((new_carry + offset) % P)  # shifted to non-negative
        num2bits(c, carry_sig, cb + 1)
        carry_lc_new = carry_sig - offset  # the signed carry as an LC
        # t_i + carry_in = carry_out * 2^n
        c.assert_equal(cols[i] + carry_lc, carry_lc_new * (1 << n))
        carry_lc = carry_lc_new
        carry_val = new_carry


def big_less_than(c: Circuit, a: FF, b_limbs: Sequence[int]) -> None:
    """Assert a < b for a constant b given as limbs (used for r < p).
    Chained limbwise compare, most-significant first: lt_i OR (eq_i AND lt_{i-1})."""
    spec = a.spec
    n = spec.n
    # lt/eq per limb via (b_i - a_i) range trick
    lt_flags: List[LC] = []
    eq_flags: List[LC] = []
    for i in range(spec.k):
        ai = a.limbs[i]
        bi = int(b_limbs[i])
        # decompose (b_i - a_i + 2^n) in n+1 bits: bit n == 1 iff a_i <= b_i
        shifted = LC.const(bi) - ai + (1 << n)
        bits = num2bits(c, shifted, n + 1)
        # bit n == 1  <=>  b_i - a_i >= 0  <=>  a_i <= b_i
        le = bits[n]
        from .core import is_zero

        eq = is_zero(c, ai - bi)
        # lt = le AND NOT eq
        lt = c.mul(le, 1 - eq)
        lt_flags.append(_lc(lt))
        eq_flags.append(_lc(eq))
    # fold MSB-first: acc = lt_k-1 + eq_k-1*(lt_k-2 + eq_k-2*(...))
    acc: LC = lt_flags[0]
    for i in range(1, spec.k):
        acc = lt_flags[i] + c.mul(eq_flags[i], acc)
    c.assert_equal(acc, 1)


def _conv_cols(
    c: Circuit, a: FF, b: FF
) -> Tuple[List[LC], List[int]]:
    """Product columns of a*b: cols[i] = sum_{j+l=i} a_j*b_l, as LCs over
    fresh product signals (k^2 mul constraints) + concrete values."""
    spec = a.spec
    k = spec.k
    prods = [[None] * k for _ in range(k)]
    prod_vals = [[0] * k for _ in range(k)]
    a_vals = [c.eval_lc(x) for x in a.limbs]
    b_vals = [c.eval_lc(x) for x in b.limbs]
    for j in range(k):
        for l in range(k):
            prods[j][l] = c.mul(a.limbs[j], b.limbs[l])
            prod_vals[j][l] = a_vals[j] * b_vals[l]
    cols: List[LC] = []
    vals: List[int] = []
    for i in range(2 * k - 1):
        acc = LC.const(0)
        v = 0
        for j in range(max(0, i - k + 1), min(k, i + 1)):
            acc = acc + prods[j][i - j]
            v += prod_vals[j][i - j]
        cols.append(acc)
        vals.append(v)
    return cols, vals


def ff_mul(c: Circuit, a: FF, b: FF, strict: bool = True) -> FF:
    """r = a*b mod p, proven via witness quotient q (k+1 limbs):
    conv(a,b) - conv(q,p) - r == 0 as a limb polynomial."""
    spec = a.spec
    assert b.spec == spec
    n, k = spec.n, spec.k
    ab = a.value * b.value
    q_int, r_int = divmod(ab, spec.p)
    assert q_int < (1 << (n * (k + 1))), "quotient overflow"

    r = ff_witness(c, spec, r_int)
    # q limbs (k+1 of them)
    q_limbs: List[Signal] = []
    qv = q_int
    for _ in range(k + 1):
        limb = c.var(qv & ((1 << n) - 1))
        num2bits(c, limb, n)
        q_limbs.append(limb)
        qv >>= n
    p_limbs = [(spec.p >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    q_vals = [(q_int >> (n * i)) & ((1 << n) - 1) for i in range(k + 1)]
    r_vals = [(r_int >> (n * i)) & ((1 << n) - 1) for i in range(k)]

    cols, vals = _conv_cols(c, a, b)
    # extend to 2k columns (conv(q,p) has k+1+k-1 = 2k terms)
    while len(cols) < 2 * k:
        cols.append(LC.const(0))
        vals.append(0)
    for i in range(2 * k):
        acc = LC.const(0)
        v = 0
        for j in range(k + 1):
            l = i - j
            if 0 <= l < k:
                acc = acc + _lc(q_limbs[j]) * p_limbs[l]
                v += q_vals[j] * p_limbs[l]
        cols[i] = cols[i] - acc
        vals[i] -= v
        if i < k:
            cols[i] = cols[i] - r.limbs[i]
            vals[i] -= r_vals[i]
    assert_limb_poly_zero(c, cols, vals, spec)
    if strict:
        big_less_than(c, r, p_limbs)
    return r


def ff_mul_eq(c: Circuit, a: FF, b: FF, out: FF) -> None:
    """Constrain a*b ≡ out (mod p); out must be canonical (< p)."""
    assert (a.value * b.value - out.value) % a.spec.p == 0, "ff_mul_eq: witness mismatch"
    r = ff_mul(c, a, b)
    ff_assert_equal(c, r, out)


def ff_assert_equal(c: Circuit, a: FF, b: FF) -> None:
    """Limbwise equality (both sides must be canonical < p)."""
    assert a.spec == b.spec
    for x, y in zip(a.limbs, b.limbs):
        c.assert_equal(x, y)


def ff_add(c: Circuit, a: FF, b: FF, strict: bool = False) -> FF:
    """(a + b) mod p with a boolean reduction quotient (requires canonical
    inputs < p). Non-strict results live in [0, 2^(nk)); the < 2^(nk)-p
    ambiguity band is removed by big_less_than at final equality sites."""
    spec = a.spec
    n, k = spec.n, spec.k
    s = a.value + b.value
    q_int, r_int = (1, s - spec.p) if s >= spec.p else (0, s)
    r = ff_witness(c, spec, r_int)
    q = c.var(q_int)
    c.constrain(q, q - 1, 0)
    p_limbs = [(spec.p >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    a_vals = [c.eval_lc(x) for x in a.limbs]
    b_vals = [c.eval_lc(x) for x in b.limbs]
    r_vals = [(r_int >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    cols, vals = [], []
    for i in range(k):
        cols.append(a.limbs[i] + b.limbs[i] - r.limbs[i] - _lc(q) * p_limbs[i])
        vals.append(a_vals[i] + b_vals[i] - r_vals[i] - q_int * p_limbs[i])
    assert_limb_poly_zero(c, cols, vals, spec)
    if strict:
        big_less_than(c, r, p_limbs)
    return r


def ff_sub(c: Circuit, a: FF, b: FF, strict: bool = False) -> FF:
    """(a - b) mod p (canonical inputs; see ff_add on strictness)."""
    spec = a.spec
    n, k = spec.n, spec.k
    d = a.value - b.value
    q_int, r_int = (1, d + spec.p) if d < 0 else (0, d)
    r = ff_witness(c, spec, r_int)
    q = c.var(q_int)
    c.constrain(q, q - 1, 0)
    p_limbs = [(spec.p >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    a_vals = [c.eval_lc(x) for x in a.limbs]
    b_vals = [c.eval_lc(x) for x in b.limbs]
    r_vals = [(r_int >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    cols, vals = [], []
    for i in range(k):
        cols.append(a.limbs[i] - b.limbs[i] - r.limbs[i] + _lc(q) * p_limbs[i])
        vals.append(a_vals[i] - b_vals[i] - r_vals[i] + q_int * p_limbs[i])
    assert_limb_poly_zero(c, cols, vals, spec)
    if strict:
        big_less_than(c, r, p_limbs)
    return r


def ff_neg(c: Circuit, a: FF) -> FF:
    return ff_sub(c, ff_const(c, a.spec, 0), a)


def ff_inv(c: Circuit, a: FF) -> FF:
    """1/a mod p: witness the inverse, constrain a * inv == 1."""
    spec = a.spec
    inv_val = pow(a.value % spec.p, -1, spec.p)
    inv = ff_witness(c, spec, inv_val)
    one = ff_const(c, spec, 1)
    r = ff_mul(c, a, inv)
    ff_assert_equal(c, r, one)
    return inv


def ff_div(c: Circuit, a: FF, b: FF) -> FF:
    """a/b mod p: witness t = a*b^-1, constrain t*b == a. One ff_mul."""
    spec = a.spec
    t_val = a.value % spec.p * pow(b.value % spec.p, -1, spec.p) % spec.p
    t = ff_witness(c, spec, t_val)
    r = ff_mul(c, t, b)
    # a must be canonical for the equality
    ff_assert_equal(c, r, a)
    return t


def ff_assert_canonical(c: Circuit, a: FF) -> None:
    """Assert a.value < p given n-bit range-checked limbs.

    Cheap form (~n + 3k constraints) when every limb of p above the lowest
    is 2^n - 1 (secp256k1 Fq/Fr, ed25519 at 85x3): with limbs bounded by
    2^n - 1, a >= p iff every upper limb EQUALS its (all-ones) p limb and
    limb 0 >= p_0 — one is_zero per upper limb, one (n+1)-bit compare on
    limb 0, and a product forced to 0. Falls back to the generic chained
    compare otherwise."""
    from .core import is_zero

    spec = a.spec
    n, k = spec.n, spec.k
    p_limbs = [(spec.p >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    m = (1 << n) - 1
    if any(pl != m for pl in p_limbs[1:]):
        big_less_than(c, a, p_limbs)
        return
    assert a.value < spec.p, "ff_assert_canonical: witness not canonical"
    # ge0 = bit n of (a_0 - p_0 + 2^n)  <=>  a_0 >= p_0
    ge0 = num2bits(c, a.limbs[0] - p_limbs[0] + (1 << n), n + 1)[n]
    acc = _lc(ge0)
    for i in range(1, k):
        acc = _lc(c.mul(acc, is_zero(c, a.limbs[i] - m)))
    c.assert_equal(acc, 0)


def ff_assert_limbs_differ(c: Circuit, a: FF, b: FF) -> None:
    """Assert a != b mod p for CANONICAL operands (< p), by limbwise
    inequality: prod_i eq_i == 0 (~3k constraints). With both values
    canonical, limb equality <=> congruence — this replaces a full
    w * (a-b) == 1 inverse congruence (~1.2k constraints at 64x4) at
    every checked chord add."""
    from .core import is_zero

    acc: Optional[LC] = None
    for x, y in zip(a.limbs, b.limbs):
        f = is_zero(c, x - y)
        acc = _lc(f) if acc is None else _lc(c.mul(acc, f))
    c.assert_equal(acc, 0)


def ff_is_equal(c: Circuit, a: FF, b: FF):
    """Boolean signal: 1 iff a == b limbwise (canonical inputs)."""
    from .core import is_zero

    flags = []
    for x, y in zip(a.limbs, b.limbs):
        flags.append(is_zero(c, x - y))
    acc = flags[0]
    for f in flags[1:]:
        acc = c.mul(acc, f)
    return acc


def ff_select(c: Circuit, sel: AnyLC, a: FF, b: FF) -> FF:
    """sel ? a : b per limb (sel boolean-constrained by caller)."""
    spec = a.spec
    sel_val = c.eval_lc(sel)
    out_limbs = []
    for x, y in zip(a.limbs, b.limbs):
        d = c.mul(sel, x - y)
        out_limbs.append(y + d)
    value = a.value if sel_val else b.value
    return FF(spec, out_limbs, value)


# ---------------------------------------------------------------------------
# Unreduced values and check-style multiplication (the cheap path).
#
# The ff_mul/ff_add family above materializes and canonicalizes every
# intermediate (witness + range check + big_less_than) — ~1.4k constraints
# per multiply. The gadgets below implement the classic cheaper pattern the
# reference's circom-ecdsa/batch-ecdsa libraries rely on (SURVEY.md §2.2):
# additions/subtractions stay FREE (limbwise LC arithmetic with static
# signed bounds), and each point-formula equation is checked as ONE
# congruence  sum_t s_t * a_t * b_t - lin ≡ 0 (mod p)  with a signed
# quotient witness and a single carry chain (~0.8-1k constraints).
# ---------------------------------------------------------------------------


class FFU:
    """Unreduced foreign-field value: k limb LCs with a static bound
    |limb_i| <= bound (signed), plus the exact signed integer value."""

    __slots__ = ("spec", "limbs", "value", "bound")

    def __init__(self, spec: FFSpec, limbs: List[LC], value: int, bound: int):
        self.spec = spec
        self.limbs = limbs
        self.value = int(value)
        self.bound = int(bound)


def ffu(a: FF) -> FFU:
    return FFU(a.spec, [_lc(x) for x in a.limbs], a.value, (1 << a.spec.n) - 1)


def ffu_const(spec: FFSpec, v: int) -> FFU:
    v = int(v) % spec.p
    return FFU(spec, [LC.const(x) for x in spec.to_limbs(v)], v, (1 << spec.n) - 1)


def ffu_add(a: FFU, b: FFU) -> FFU:
    return FFU(
        a.spec,
        [x + y for x, y in zip(a.limbs, b.limbs)],
        a.value + b.value,
        a.bound + b.bound,
    )


def ffu_sub(a: FFU, b: FFU) -> FFU:
    return FFU(
        a.spec,
        [x - y for x, y in zip(a.limbs, b.limbs)],
        a.value - b.value,
        a.bound + b.bound,
    )


def ffu_scale(a: FFU, s: int) -> FFU:
    return FFU(a.spec, [x * s for x in a.limbs], a.value * s, a.bound * abs(int(s)))


def _limb_lcs(x) -> List[LC]:
    return [_lc(v) for v in x.limbs]


def ff_check_congruence(
    c: Circuit,
    spec: FFSpec,
    prods: Sequence[Tuple[object, object, int]],  # (x, y, signed scale)
    lin: Optional[FFU] = None,
    lin_sign: int = -1,
) -> None:
    """Constrain  sum_t scale_t * x_t * y_t  + lin_sign * lin  ≡ 0 (mod p).

    x_t, y_t are FF or FFU (limb LCs with bounds); products cost one mul
    constraint per limb pair (k^2 per term). The quotient q is witnessed
    SIGNED via a constant shift, and one signed carry chain closes the
    identity — no result witness, no canonicalization."""
    n, k = spec.n, spec.k

    def bound_of(x) -> int:
        return x.bound if isinstance(x, FFU) else (1 << spec.n) - 1

    def value_of(x) -> int:
        return x.value

    # exact integer value of the whole expression
    total = 0
    for x, y, s in prods:
        total += int(s) * value_of(x) * value_of(y)
    if lin is not None:
        total += lin_sign * lin.value
    assert total % spec.p == 0, "ff_check_congruence: witness not congruent"
    q = total // spec.p

    # columns of the products
    ncols = 2 * k  # k+2 q-limbs x k p-limbs reach at most col 2k-1; pad
    cols: List[LC] = [LC.const(0) for _ in range(ncols)]
    col_bound = [0] * ncols
    for x, y, s in prods:
        xl, yl = _limb_lcs(x), _limb_lcs(y)
        bx, by = bound_of(x), bound_of(y)
        s = int(s)
        for j in range(k):
            for l in range(k):
                pjl = c.mul(xl[j], yl[l])
                cols[j + l] = cols[j + l] + _lc(pjl) * (s % P)
                col_bound[j + l] += abs(s) * bx * by
    if lin is not None:
        for j in range(k):
            cols[j] = cols[j] + lin.limbs[j] * (lin_sign % P)
            col_bound[j] += lin.bound

    # subtract conv(q, p): q = q_shifted - Q0, q_shifted in [0, 2*Q0).
    # Q0 must be a CIRCUIT constant (cannot depend on the witness q), so it
    # is sized from the static column bounds: |q| <= sum_cols bound / p + 1.
    p_limbs = [(spec.p >> (n * i)) & ((1 << n) - 1) for i in range(k)]
    expr_bound = sum(b << (n * i) for i, b in enumerate(col_bound))
    qmax = expr_bound // spec.p + 1
    assert abs(q) <= qmax
    q0 = 1 << qmax.bit_length()
    qs = q + q0  # non-negative
    qs_bits = max((2 * q0 - 1).bit_length(), 1)
    nqs = (qs_bits + n - 1) // n  # static limb count
    qs_limbs: List[Signal] = []
    v = qs
    for j in range(nqs):
        limb = c.var(v & ((1 << n) - 1))
        # top limb only holds the remaining bits — check just those
        num2bits(c, limb, min(n, qs_bits - n * j))
        qs_limbs.append(limb)
        v >>= n
    assert v == 0
    q0_limbs = [(q0 >> (n * i)) & ((1 << n) - 1) for i in range(nqs)]
    while len(cols) < nqs + k:
        cols.append(LC.const(0))
        col_bound.append(0)
    for j in range(nqs):
        for l in range(k):
            # -(qs_j - Q0_j) * p_l  (linear: p_l constant)
            cols[j + l] = cols[j + l] - _lc(qs_limbs[j]) * p_limbs[l] + LC.const(
                q0_limbs[j] * p_limbs[l] % P
            )
            col_bound[j + l] += (1 << n) * p_limbs[l] + q0_limbs[j] * p_limbs[l]

    # signed carry chain sized by the true column bounds: |carry| <=
    # (max_col + |prev_carry|) / 2^n, whose fixpoint is < max_col/2^n + 1
    max_bound = max(col_bound) if col_bound else 1
    cb = max(max_bound.bit_length() - n + 1, 1)
    offset = 1 << cb
    # concrete signed column values for the carry witnesses
    vals = [0] * len(cols)
    for x, y, s in prods:
        xl = _signed_limb_vals(c, x, spec)
        yl = _signed_limb_vals(c, y, spec)
        for j in range(k):
            for l in range(k):
                vals[j + l] += int(s) * xl[j] * yl[l]
    if lin is not None:
        ll = _signed_limb_vals(c, lin, spec)
        for j in range(k):
            vals[j] += lin_sign * ll[j]
    for j in range(nqs):
        qv = (qs >> (n * j)) & ((1 << n) - 1)
        for l in range(k):
            vals[j + l] -= (qv - q0_limbs[j]) * p_limbs[l]

    carry_val = 0
    carry_lc: LC = LC.const(0)
    for i in range(len(cols)):
        total_val = vals[i] + carry_val
        if i == len(cols) - 1:
            assert total_val == 0, "congruence carry chain: nonzero final"
            c.assert_equal(cols[i] + carry_lc, 0)
            return
        assert total_val % (1 << n) == 0, "congruence carry: not divisible"
        new_carry = total_val >> n
        assert -offset <= new_carry < offset, "congruence carry out of range"
        carry_sig = c.var((new_carry + offset) % P)
        num2bits(c, carry_sig, cb + 1)
        carry_lc_new = carry_sig - offset
        c.assert_equal(cols[i] + carry_lc, carry_lc_new * (1 << n))
        carry_lc = carry_lc_new
        carry_val = new_carry


def _signed_limb_vals(c: Circuit, x, spec: FFSpec) -> List[int]:
    """Exact signed per-limb values of an FF/FFU (center-lift LC evals)."""
    out = []
    half = (P - 1) // 2
    for lc_ in (x.limbs if isinstance(x, FFU) else [_lc(v) for v in x.limbs]):
        v = c.eval_lc(lc_)
        out.append(v - P if v > half else v)
    return out


def ff_witness_checked(
    c: Circuit, spec: FFSpec, value: int, keep_bits: bool = False
) -> FF:
    """Alias of ff_witness (range-checked limbs, optionally keeping bits) —
    named for use in check-style gadgets where the value is NOT canonical-
    checked (< 2^(nk) only); all downstream uses are mod-p congruences."""
    return ff_witness(c, spec, value % (1 << (spec.n * spec.k)), keep_bits=keep_bits)


def _init_specs():
    global SECP_FQ, SECP_FR, BN254_FQ_FF, ED25519_FQ_FF
    from ...fields import bn254 as _bn, curve25519 as _c25519, secp256k1 as _secp

    SECP_FQ = FFSpec(_secp.P, 64, 4, "secp_fq")
    SECP_FR = FFSpec(_secp.N, 64, 4, "secp_fr")
    BN254_FQ_FF = FFSpec(_bn.P, 43, 6, "bn254_fq")
    ED25519_FQ_FF = FFSpec(_c25519.P, 85, 3, "ed25519_fq")


_init_specs()
