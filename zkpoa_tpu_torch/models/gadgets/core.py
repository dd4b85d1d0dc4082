# Copy of zkpoa_tpu/models/gadgets/core.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Core constraint gadgets (circomlib-equivalent, rebuilt from the math):
bit decomposition, bit recomposition, muxes, equality/range helpers.

Behavioral parity targets: circomlib Num2Bits/Bits2Num and the DualMux of
circuits/merkle.circom:11-19 in the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ...fields.bn254 import R as P
from ..r1cs import LC, AnyLC, Circuit, Signal


def num2bits(c: Circuit, x: AnyLC, n_bits: int) -> List[Signal]:
    """Decompose x into n_bits little-endian bits; constrains each bit
    boolean and the weighted sum equal to x. Uses the raw constraint fast
    path — bit decomposition dominates circuit build time (it is ~90% of
    the constraints of the foreign-field gadgets)."""
    val = c.eval_lc(x)
    if val >= (1 << n_bits):
        raise AssertionError(f"value {val} does not fit in {n_bits} bits")
    from ..r1cs import _lc

    wires = c.raw_bits(val, n_bits)
    # recomposition: (sum 2^i b_i - x) * 1 == 0
    a_terms = [(w, (1 << i) % P) for i, w in enumerate(wires)]
    for w, co in _lc(x).terms.items():
        a_terms.append((w, (-co) % P))
    c.raw_constrain(a_terms, [(0, 1)], [])
    return [Signal(c, w) for w in wires]


def bits2num(c: Circuit, bits: Sequence[AnyLC]) -> LC:
    from ..r1cs import _lc

    acc = LC.const(0)
    for i, b in enumerate(bits):
        acc = acc + _lc(b) * (1 << i)
    return acc


def dual_mux(c: Circuit, a: AnyLC, b: AnyLC, s: AnyLC) -> Tuple[LC, LC]:
    """Return (out0, out1) = (a, b) if s == 0 else (b, a). One product
    constraint; s must already be boolean-constrained."""
    from ..r1cs import _lc

    a, b = _lc(a), _lc(b)
    diff = c.mul(b - a, s)  # diff = s*(b-a)
    return (a + diff, b - diff)


def is_zero(c: Circuit, x: AnyLC) -> Signal:
    """1 if x == 0 else 0 (circomlib IsZero: inv witness + 2 constraints)."""
    val = c.eval_lc(x)
    inv = c.var(pow(val, -1, P) if val else 0)
    out = c.var(0 if val else 1)
    from ..r1cs import _lc

    c.constrain(_lc(x), inv, _lc(1) - out)  # x*inv = 1-out
    c.constrain(_lc(x), out, 0)  # x*out = 0
    return out


def assert_less_than(c: Circuit, a: AnyLC, b: AnyLC, n_bits: int) -> None:
    """a < b for values known to fit n_bits (circomlib LessThan pattern:
    decompose a - b + 2^n and check the top bit)."""
    val = (c.eval_lc(a) - c.eval_lc(b)) % P
    from ..r1cs import _lc

    shifted = _lc(a) - _lc(b) + (1 << n_bits)
    bits = num2bits(c, shifted, n_bits + 1)
    # top bit == 0  <=>  a < b
    c.assert_equal(bits[n_bits], 0)
