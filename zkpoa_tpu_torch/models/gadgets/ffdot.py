# Copy of zkpoa_tpu/models/gadgets/ffdot.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Lazy-reduction foreign-field engine for the in-snark pairing verifier.

The reference's circom-pairing expresses BN254 Fq arithmetic over 43x6
registers with one quotient/carry reduction per field *multiplication*
(~19.5M constraints for verifyProof — SURVEY.md §2.2). This engine is the
framework's redesign of that layer around one observation: in R1CS the
expensive part of a foreign-field op is the *reduction* (quotient + result
+ carry range checks, ~1.1k constraints), not the limb products (~9). So
arbitrary integer combinations  sum_t coeff_t * a_t * b_t + linear + const
are accumulated column-wise as exact integers with per-column abs-bound
tracking, and reduced mod p ONCE:

    V = sum_i col_i * 2^(n*i)          (exact, signed)
    V = q*p + r,   q balanced-signed digits, r in [0, p)
    columns(V - q*p - r) == 0          via a signed carry chain

Every whole Fp12 multiplication then costs 12 reductions (one per output
coefficient) instead of ~54+, which is where the gadget's ~3x constraint
advantage over the reference comes from.

Limb layout: n=86, k=3 for BN254 Fq (the reference's 43x6 I/O registers
convert linearly: limb86_i = reg43_{2i} + 2^43 * reg43_{2i+1}).

Soundness: all witness wires (r limbs, q digits, carries) are bit-range
checked; column bounds are tracked exactly and asserted < 2^249 so no
native-field (BN254 Fr, 254-bit) wraparound is possible; the carry chain
then proves the integer identity V - q*p - r = 0, hence r ≡ V (mod p).
An adversary may shift (q, r) jointly, changing r only by multiples of p —
all consumers compare values mod p (reduce_zero), never limb-wise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ...fields.bn254 import R as NATIVE_P
from ..r1cs import Circuit

P_NATIVE = NATIVE_P

# native-field headroom ceiling for any column value (|col| < 2^249 << P/2)
_COL_BOUND_CEIL = 1 << 249


@dataclass(frozen=True)
class DotSpec:
    """Foreign field p with k limbs of n bits."""

    p: int
    n: int
    k: int
    name: str = ""

    @property
    def mask(self) -> int:
        return (1 << self.n) - 1

    def p_limbs(self) -> List[int]:
        return [(self.p >> (self.n * i)) & self.mask for i in range(self.k)]

    def to_limbs(self, x: int) -> List[int]:
        x %= self.p
        return [(x >> (self.n * i)) & self.mask for i in range(self.k)]


class FE:
    """Foreign-field element: k limbs as {wire: coeff} dicts over the
    native field, exact integer limb values, and a shared per-limb abs
    bound. Fresh (reduced/witnessed) elements have single-wire limbs and
    bound 2^n - 1; linear combinations carry larger bounds."""

    __slots__ = ("spec", "limbs", "limb_vals", "bound")

    def __init__(self, spec: DotSpec, limbs: List[Dict[int, int]], limb_vals: List[int], bound: int):
        self.spec = spec
        self.limbs = limbs
        self.limb_vals = limb_vals
        self.bound = bound

    @property
    def value(self) -> int:
        """Exact (signed) integer value of the limb vector."""
        n = self.spec.n
        return sum(v << (n * i) for i, v in enumerate(self.limb_vals))

    @property
    def value_mod_p(self) -> int:
        return self.value % self.spec.p


def fe_const(spec: DotSpec, x: int) -> FE:
    vals = spec.to_limbs(x)
    return FE(spec, [{0: v} if v else {} for v in vals], vals, spec.mask)


def fe_witness(c: Circuit, spec: DotSpec, x: int) -> FE:
    """Allocate x (0 <= x < 2^(nk)) as fresh range-checked limbs."""
    assert 0 <= x < (1 << (spec.n * spec.k))
    limbs, vals = [], []
    for i in range(spec.k):
        lv = (x >> (spec.n * i)) & spec.mask
        wire = _checked_limb(c, lv, spec.n)
        limbs.append({wire: 1})
        vals.append(lv)
    return FE(spec, limbs, vals, spec.mask)


def fe_lin(spec: DotSpec, items: Sequence[Tuple[int, FE]], const: int = 0) -> FE:
    """Linear combination sum coeff*fe + const — no constraints, larger
    bound. `const` must be in [0, 2^(nk))."""
    assert 0 <= const < (1 << (spec.n * spec.k))
    limbs: List[Dict[int, int]] = [{} for _ in range(spec.k)]
    vals = [0] * spec.k
    bound = 0
    for coeff, fe in items:
        cm = coeff % P_NATIVE
        for i in range(spec.k):
            d = limbs[i]
            for w, co in fe.limbs[i].items():
                v = (d.get(w, 0) + co * cm) % P_NATIVE
                if v:
                    d[w] = v
                else:
                    d.pop(w, None)
            vals[i] += coeff * fe.limb_vals[i]
        bound += abs(coeff) * fe.bound
    if const:
        for i in range(spec.k):
            cl = (const >> (spec.n * i)) & spec.mask
            if cl:
                limbs[i][0] = (limbs[i].get(0, 0) + cl) % P_NATIVE
                vals[i] += cl
        bound += spec.mask
    return FE(spec, limbs, vals, bound)


def _checked_limb(c: Circuit, val: int, n: int) -> int:
    """Allocate a wire == val with an n-bit range check (bits + binding)."""
    wire = c.raw_var(val)
    bit_wires = c.raw_bits(val, n)
    a_terms = [(bw, (1 << t) % P_NATIVE) for t, bw in enumerate(bit_wires)]
    a_terms.append((wire, P_NATIVE - 1))
    c.raw_constrain(a_terms, ((0, 1),), ())
    return wire


class Conv:
    """Product/linear columns: cols[i] as {wire: coeff}, exact signed
    vals[i], abs bounds[i]."""

    __slots__ = ("cols", "vals", "bounds")

    def __init__(self, cols, vals, bounds):
        self.cols = cols
        self.vals = vals
        self.bounds = bounds


def conv_mul(c: Circuit, a: FE, b: FE) -> Conv:
    """Signal x signal product: k^2 fresh product wires (k^2 constraints);
    columns of the limb convolution."""
    spec = a.spec
    k = spec.k
    cols: List[Dict[int, int]] = [{} for _ in range(2 * k - 1)]
    vals = [0] * (2 * k - 1)
    pb = a.bound * b.bound
    bounds = [0] * (2 * k - 1)
    for j in range(k):
        aj_terms = tuple(a.limbs[j].items())
        av = a.limb_vals[j]
        for l in range(k):
            v = av * b.limb_vals[l]
            wire = c.raw_var(v % P_NATIVE)
            c.raw_constrain(aj_terms, tuple(b.limbs[l].items()), ((wire, 1),))
            i = j + l
            cols[i][wire] = cols[i].get(wire, 0) + 1
            vals[i] += v
            bounds[i] += pb
    return Conv(cols, vals, bounds)


class ProdWires:
    """The k x k limb-product wires of a signal pair (a, b), reusable
    across several reductions (e.g. both w^1 and w^7 line positions)."""

    __slots__ = ("spec", "wires", "vals", "bound")

    def __init__(self, spec: DotSpec, wires, vals, bound: int):
        self.spec = spec
        self.wires = wires
        self.vals = vals
        self.bound = bound


def prod_wires(c: Circuit, a: FE, b: FE) -> ProdWires:
    spec = a.spec
    k = spec.k
    wires = [[0] * k for _ in range(k)]
    vals = [[0] * k for _ in range(k)]
    for j in range(k):
        aj_terms = tuple(a.limbs[j].items())
        av = a.limb_vals[j]
        for l in range(k):
            v = av * b.limb_vals[l]
            wire = c.raw_var(v % P_NATIVE)
            c.raw_constrain(aj_terms, tuple(b.limbs[l].items()), ((wire, 1),))
            wires[j][l] = wire
            vals[j][l] = v
    return ProdWires(spec, wires, vals, a.bound * b.bound)


def conv_of_prods(pw: ProdWires, const: int = 1) -> Conv:
    """Columns of a*b*const (const a field constant, limb-split)."""
    spec = pw.spec
    k = spec.k
    cl = spec.to_limbs(const % spec.p)
    ncols = 3 * k - 2
    cols: List[Dict[int, int]] = [{} for _ in range(ncols)]
    vals = [0] * ncols
    bounds = [0] * ncols
    for j in range(k):
        for l in range(k):
            w = pw.wires[j][l]
            v = pw.vals[j][l]
            for m in range(k):
                if not cl[m]:
                    continue
                i = j + l + m
                d = cols[i]
                d[w] = (d.get(w, 0) + cl[m]) % P_NATIVE
                vals[i] += v * cl[m]
                bounds[i] += pw.bound * cl[m]
    return Conv(cols, vals, bounds)


def conv_const(a: FE, const: int) -> Conv:
    """a x (field constant) — pure linear columns, no constraints."""
    spec = a.spec
    k = spec.k
    const %= spec.p
    cl = spec.to_limbs(const)
    cols: List[Dict[int, int]] = [{} for _ in range(2 * k - 1)]
    vals = [0] * (2 * k - 1)
    bounds = [0] * (2 * k - 1)
    for j in range(k):
        for l in range(k):
            if not cl[l]:
                continue
            i = j + l
            d = cols[i]
            for w, co in a.limbs[j].items():
                v = (d.get(w, 0) + co * cl[l]) % P_NATIVE
                if v:
                    d[w] = v
                else:
                    d.pop(w, None)
            vals[i] += a.limb_vals[j] * cl[l]
            bounds[i] += a.bound * cl[l]
    return Conv(cols, vals, bounds)


def conv_lin(a: FE) -> Conv:
    """a itself as k columns (for linear terms in a reduction)."""
    k = a.spec.k
    return Conv(
        [dict(a.limbs[i]) for i in range(k)],
        list(a.limb_vals),
        [a.bound] * k,
    )


def _merge_terms(spec: DotSpec, terms, const: int):
    ncols = max((len(t[1].cols) for t in terms), default=spec.k)
    cols: List[Dict[int, int]] = [{} for _ in range(ncols)]
    vals = [0] * ncols
    bounds = [0] * ncols
    for coeff, conv in terms:
        cm = coeff % P_NATIVE
        ca = abs(coeff)
        for i, col in enumerate(conv.cols):
            d = cols[i]
            for w, co in col.items():
                v = (d.get(w, 0) + co * cm) % P_NATIVE
                if v:
                    d[w] = v
                else:
                    d.pop(w, None)
            vals[i] += coeff * conv.vals[i]
            bounds[i] += ca * conv.bounds[i]
    if const:
        # balanced n-bit decomposition of the constant across columns
        mask, half = spec.mask, 1 << (spec.n - 1)
        cc = const
        i = 0
        while cc:
            d = ((cc + half) & mask) - half
            cc = (cc - d) >> spec.n
            if i >= ncols:
                cols.append({})
                vals.append(0)
                bounds.append(0)
                ncols += 1
            if d:
                cols[i][0] = (cols[i].get(0, 0) + d) % P_NATIVE
                vals[i] += d
                bounds[i] += abs(d)
            i += 1
    return cols, vals, bounds


def _reduce(c: Circuit, spec: DotSpec, terms, const: int, want_r: bool) -> Optional[FE]:
    n, k, mask = spec.n, spec.k, spec.mask
    half = 1 << (n - 1)
    pl = spec.p_limbs()
    cols, vals, bounds = _merge_terms(spec, terms, const)

    v_total = sum(vals[i] << (n * i) for i in range(len(cols)))
    v_max = sum(bounds[i] << (n * i) for i in range(len(cols)))
    q, r = divmod(v_total, spec.p)

    out = None
    if want_r:
        out_limbs, out_vals = [], []
        for i in range(k):
            lv = (r >> (n * i)) & mask
            wire = _checked_limb(c, lv, n)
            out_limbs.append({wire: 1})
            out_vals.append(lv)
            cols[i][wire] = (cols[i].get(wire, 0) - 1) % P_NATIVE
            vals[i] -= lv
            bounds[i] += mask
        out = FE(spec, out_limbs, out_vals, mask)
    else:
        assert r == 0, f"reduce_zero: value not divisible (r={r})"

    # quotient: balanced signed digits, count sized from the value bound
    bq = v_max // spec.p + 2
    kq = 1
    while (1 << (n * kq - 1)) <= bq:
        kq += 1
    ncols_needed = kq + k - 1
    while len(cols) < ncols_needed:
        cols.append({})
        vals.append(0)
        bounds.append(0)
    qd = q
    for j in range(kq):
        d = ((qd + half) & mask) - half
        qd = (qd - d) >> n
        s_wire = _checked_limb(c, d + half, n)  # shifted digit in [0, 2^n)
        for l in range(k):
            if not pl[l]:
                continue
            i = j + l
            dd = cols[i]
            dd[s_wire] = (dd.get(s_wire, 0) - pl[l]) % P_NATIVE
            dd[0] = (dd.get(0, 0) + half * pl[l]) % P_NATIVE
            vals[i] -= d * pl[l]
            bounds[i] += (half + 1) * pl[l]
    assert qd == 0, "quotient digit overflow"

    # signed carry chain
    ncols = len(cols)
    carry_val = 0
    carry_wire = None
    carry_off = 0
    carry_bound = 0
    for i in range(ncols):
        tot_val = vals[i] + carry_val
        tot_bound = bounds[i] + carry_bound
        assert tot_bound < _COL_BOUND_CEIL, "column bound exceeds native headroom"
        a_terms = list(cols[i].items())
        if carry_wire is not None:
            a_terms.append((carry_wire, 1))
        c0 = cols[i].get(0, 0)
        # move/merge the constant + carry offset onto wire 0
        extra_const = -carry_off
        if i == ncols - 1:
            assert tot_val == 0, "nonzero final carry"
            _set_const(a_terms, c0, extra_const)
            c.raw_constrain(a_terms, ((0, 1),), ())
            break
        assert tot_val % (1 << n) == 0, "column not divisible by 2^n"
        new_carry = tot_val >> n
        cb = max((tot_bound >> n).bit_length() + 1, 2)
        off = 1 << cb
        assert -off <= new_carry < off
        s_wire = _checked_limb(c, new_carry + off, cb + 1)
        # col + carry_in - 2^n * (s - off) == 0
        a_terms.append((s_wire, (P_NATIVE - (1 << n)) % P_NATIVE))
        _set_const(a_terms, c0, extra_const + (off << n))
        c.raw_constrain(a_terms, ((0, 1),), ())
        carry_val = new_carry
        carry_wire = s_wire
        carry_off = off << 0
        # the carry LC is (s_wire - off); fold -off into next column's const
        carry_bound = off
    return out


def _set_const(a_terms: List[Tuple[int, int]], existing_c0: int, extra: int) -> None:
    """Replace/insert the wire-0 coefficient = existing + extra (mod P)."""
    total = (existing_c0 + extra) % P_NATIVE
    for idx, (w, _) in enumerate(a_terms):
        if w == 0:
            if total:
                a_terms[idx] = (0, total)
            else:
                a_terms.pop(idx)
            return
    if total:
        a_terms.append((0, total))


def reduce_to_fe(c: Circuit, spec: DotSpec, terms, const: int = 0) -> FE:
    """Constrain sum coeff*conv + const ≡ r (mod p); return fresh r."""
    return _reduce(c, spec, terms, const, want_r=True)


def reduce_zero(c: Circuit, spec: DotSpec, terms, const: int = 0) -> None:
    """Constrain sum coeff*conv + const ≡ 0 (mod p) (exact divisibility)."""
    _reduce(c, spec, terms, const, want_r=False)


# convenience wrappers -------------------------------------------------------


def fe_mul(c: Circuit, a: FE, b: FE) -> FE:
    return reduce_to_fe(c, a.spec, [(1, conv_mul(c, a, b))])


def fe_assert_eq(c: Circuit, a: FE, b: FE) -> None:
    """a ≡ b (mod p)."""
    reduce_zero(c, a.spec, [(1, conv_lin(a)), (-1, conv_lin(b))])


def fe_assert_value(c: Circuit, a: FE, x: int) -> None:
    """a ≡ x (mod p) for a host constant x."""
    reduce_zero(c, a.spec, [(1, conv_lin(a)), (-1, conv_lin(fe_const(a.spec, x)))])


def fe_inv_witness(c: Circuit, a: FE) -> FE:
    """Witness 1/a and constrain a * inv ≡ 1 (mod p). Forces a != 0."""
    spec = a.spec
    inv_val = pow(a.value_mod_p, -1, spec.p)
    inv = fe_witness(c, spec, inv_val)
    reduce_zero(c, spec, [(1, conv_mul(c, a, inv))], const=-1)
    return inv
