"""The NTTs that the Groth16 quotient at the key's domain needs.

h(X) = (A B - C) / Z on a domain of m points with a monomial h-query:
three inverse transforms (A, B, C to coefficients), three forward ones
on the coset, one inverse on the coset back to h's coefficients: seven,
each m/2 log2 m Montgomery butterfly products, its input read once and
its output written once (32 bytes an element). The coset scalings and
the pointwise products are not counted."""

from __future__ import annotations

from ..peaks import MONT_OPS

TRANSFORMS = 7
ELEMENT_BYTES = 32


def work(ctx, req):
    m = ctx.pool.statement().domain
    products = TRANSFORMS * (m // 2) * (m.bit_length() - 1)
    return products * MONT_OPS, TRANSFORMS * 2 * ELEMENT_BYTES * m
