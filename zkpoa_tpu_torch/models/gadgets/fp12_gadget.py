# Copy of zkpoa_tpu/models/gadgets/fp12_gadget.py; only its imports are rewritten for zkpoa_tpu_torch.
"""In-circuit Fp12 arithmetic in the direct polynomial basis.

Fp12 = Fp[w]/(w^12 - 18 w^6 + 82) (fields/bn254_direct.py): an element is
12 foreign-field coefficients (ffdot.FE, 86x3 limbs). A full product is
one 23-column convolution folded by the reduction polynomial and reduced
once per output coefficient — 12 reductions + 144 limb-product sets,
~15k constraints, vs ~54 reductions for the same op in the reference's
tower representation (circom-pairing fp12.circom; SURVEY.md §2.2).

Line-sparse products exploit the 034 shape of Miller lines (direct
positions {0,1,3,7,9}; fields/bn254_direct.py line_value): for lines with
constant G2 coefficients the w-coefficients are constant multiples of the
two per-G1-point signals, so the product needs only 24 limb-product sets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ...fields import bn254 as bn
from ...fields import bn254_direct as bd
from ..r1cs import Circuit
from . import ffdot as FF
from .ffdot import FE, Conv, DotSpec, conv_const, conv_lin, conv_mul, fe_const, fe_lin, fe_witness, reduce_to_fe, reduce_zero

FQ = DotSpec(bn.P, 86, 3, "bn254_fq_86x3")

# fold table: w^t for t in 0..22 as [(degree, coeff)]
_FOLD: List[List[Tuple[int, int]]] = []
for _t in range(23):
    if _t < 12:
        _FOLD.append([(_t, 1)])
    elif _t < 18:
        _FOLD.append([(_t - 6, 18), (_t - 12, -82)])
    else:
        _FOLD.append([(_t - 12, 242), (_t - 18, -1476)])

ONE_DIRECT = tuple([1] + [0] * 11)


class Fq12:
    """12 FE coefficients (direct basis) + the exact host value mirror."""

    __slots__ = ("co",)

    def __init__(self, co: List[FE]):
        assert len(co) == 12
        self.co = co

    @property
    def direct_value(self) -> Tuple[int, ...]:
        return tuple(fe.value_mod_p for fe in self.co)

    @property
    def tower_value(self):
        return bd.direct_to_tower(self.direct_value)


def fq12_const(direct: Sequence[int]) -> Fq12:
    return Fq12([fe_const(FQ, x) for x in direct])


def fq12_witness(c: Circuit, direct: Sequence[int]) -> Fq12:
    return Fq12([fe_witness(c, FQ, x % bn.P) for x in direct])


def _prod_cache_mul(c: Circuit, cache: Dict, a: FE, b: FE) -> Conv:
    key = (id(a), id(b))
    conv = cache.get(key)
    if conv is None:
        conv = conv_mul(c, a, b)
        cache[key] = conv
    return conv


def fq12_mul(c: Circuit, a: Fq12, b: Fq12, eq_const: Optional[Sequence[int]] = None) -> Optional[Fq12]:
    """a*b reduced per output coefficient. If eq_const is given, instead
    constrain a*b ≡ eq_const (mod p) coefficient-wise and return None
    (saves the 12 result allocations)."""
    sq = a is b
    convs: Dict[Tuple[int, int], Conv] = {}
    for i in range(12):
        for j in range(12):
            if sq and j < i:
                continue
            convs[(i, j)] = conv_mul(c, a.co[i], b.co[j])
    out = []
    terms_by_deg: List[List[Tuple[int, Conv]]] = [[] for _ in range(12)]
    for (i, j), conv in convs.items():
        mult = 2 if (sq and j > i) else 1
        for deg, coeff in _FOLD[i + j]:
            terms_by_deg[deg].append((coeff * mult, conv))
    if eq_const is None:
        return Fq12([reduce_to_fe(c, FQ, terms_by_deg[m]) for m in range(12)])
    for m in range(12):
        reduce_zero(c, FQ, terms_by_deg[m], const=-(eq_const[m] % bn.P))
    return None


def fq12_sq(c: Circuit, a: Fq12) -> Fq12:
    return fq12_mul(c, a, a)


def fq12_mul_const(c: Circuit, a: Fq12, k_direct: Sequence[int]) -> Fq12:
    """a x constant Fp12 — pure linear, 12 reductions, no products."""
    terms_by_deg: List[List[Tuple[int, Conv]]] = [[] for _ in range(12)]
    for i in range(12):
        ai = a.co[i]
        for j in range(12):
            kj = k_direct[j] % bn.P
            if not kj:
                continue
            conv = conv_const(ai, kj)
            for deg, coeff in _FOLD[i + j]:
                terms_by_deg[deg].append((coeff, conv))
    return Fq12([reduce_to_fe(c, FQ, terms_by_deg[m]) for m in range(12)])


# line positions: value = 1 + D1 w + D3 w^3 + D7 w^7 + D9 w^9
_LINE_POS = (1, 3, 7, 9)


def line_coeffs_const(c: Circuit, s1: FE, s2: FE, cw, cw3) -> Tuple[FE, FE, FE, FE]:
    """Materialize the direct line coefficients for CONSTANT G2 line
    coefficients cw, cw3 (Fp2 host ints): the line is
    1 + cw*s1*w + cw3*s2*w^3, i.e. D1=(cw.x-9 cw.y)s1, D7=cw.y s1,
    D3=(cw3.x-9 cw3.y)s2, D9=cw3.y s2 — four constant-scale reductions."""
    d1 = reduce_to_fe(c, FQ, [(1, conv_const(s1, (cw[0] - 9 * cw[1]) % bn.P))])
    d7 = reduce_to_fe(c, FQ, [(1, conv_const(s1, cw[1] % bn.P))])
    d3 = reduce_to_fe(c, FQ, [(1, conv_const(s2, (cw3[0] - 9 * cw3[1]) % bn.P))])
    d9 = reduce_to_fe(c, FQ, [(1, conv_const(s2, cw3[1] % bn.P))])
    return d1, d7, d3, d9


def fq12_mul_line_var(c: Circuit, f: Fq12, d1: FE, d7: FE, d3: FE, d9: FE) -> Fq12:
    """f x line with materialized (signal) direct coefficients D1/D7/D3/D9."""
    ds = {1: d1, 7: d7, 3: d3, 9: d9}
    terms_by_deg: List[List[Tuple[int, Conv]]] = [[] for _ in range(12)]
    for i in range(12):
        terms_by_deg[i].append((1, conv_lin(f.co[i])))
        for pos, d in ds.items():
            conv = conv_mul(c, f.co[i], d)
            for deg, coeff in _FOLD[i + pos]:
                terms_by_deg[deg].append((coeff, conv))
    return Fq12([reduce_to_fe(c, FQ, terms_by_deg[m]) for m in range(12)])


# Frobenius constants: W_FROB[k][i] = direct((w^(p^k))^i), k = 1, 2, 3
def _w_frob_consts() -> List[List[Tuple[int, ...]]]:
    # basis element w in tower form: second Fp6 component = (1, 0, 0)
    w_elem = ((((0, 0)), ((0, 0)), ((0, 0))), (((1, 0)), ((0, 0)), ((0, 0))))
    out = []
    for k in range(1, 4):
        wp = w_elem
        for _ in range(k):
            wp = bn.fp12_frobenius(wp)
        pows = [bn.FP12_ONE]
        for _ in range(11):
            pows.append(bn.fp12_mul(pows[-1], wp))
        out.append([bd.tower_to_direct(x) for x in pows])
    return out


_W_FROB = _w_frob_consts()


def fq12_frobenius(c: Circuit, a: Fq12, power: int) -> Fq12:
    """a -> a^(p^power) for power in {1,2,3}: out = sum_i a_i * W[i],
    a constant-matrix linear map (12 reductions, no products)."""
    w_tab = _W_FROB[power - 1]
    terms_by_deg: List[List[Tuple[int, Conv]]] = [[] for _ in range(12)]
    for i in range(12):
        ai = a.co[i]
        wi = w_tab[i]
        for j in range(12):
            kj = wi[j] % bn.P
            if not kj:
                continue
            conv = conv_const(ai, kj)
            for deg, coeff in _FOLD[j]:
                terms_by_deg[deg].append((coeff, conv))
    return Fq12([reduce_to_fe(c, FQ, terms_by_deg[m]) for m in range(12)])
