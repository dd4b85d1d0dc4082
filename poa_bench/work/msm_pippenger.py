"""The MSMs of a Groth16 prove, reckoned from the scalars and the key's
points alone.

The a, b1 and c queries (G1) and the b2 query (G2) take the witness as
scalars, the h query (G1) the m - 1 coefficients of h. A point is in an
MSM where the key's point is not the identity: wire k's a- and b-points
exist where column k of A, of B has an entry, its c-point where a private
wire has an entry in any matrix; all m - 1 h-points exist. Per MSM:

- a zero scalar costs nothing, a scalar of one one addition;
- a value v that k >= 2 points share costs k - 1 additions to sum them,
  then one multiplication by double-and-add: bits(v) - 1 doublings and
  popcount(v) - 1 additions;
- the values that occur once cost a Pippenger sum at the window width c
  that minimises its count: each value ceil(bits / c) digits, a share
  2^-c of them zero, one addition a nonzero digit; 2^c additions a window
  to reduce its 2^(c-1) signed buckets; (W - 1) c doublings and W - 1
  additions to combine the W windows. h's coefficients are not known
  before the prove, so they count as m - 1 values of 254 bits.

A group operation costs 6 base-field products in G1 (an affine addition
with its share of a batched inversion: 3 products for the share, 3 for
the formula) and three times as many in G2, MONT_OPS int32 operations a
product. Every point is read once (64 bytes in G1, 128 in G2), every
scalar once (32 bytes).
"""

from __future__ import annotations

import math

import numpy as np

from ..peaks import MONT_OPS

G1_PRODUCTS = 6
G2_PRODUCTS = 18
FULL_BITS = 254


def pippenger_ops(bits: np.ndarray) -> float:
    """Group operations of the least Pippenger count over values of these
    bit lengths."""
    if len(bits) == 0:
        return 0.0
    top, best = int(bits.max()), math.inf
    for c in range(1, 25):
        w = -(-top // c)
        digits = float(np.ceil(bits / c).sum()) * (1 - 2.0 ** -c)
        best = min(best, digits + w * 2 ** c + (w - 1) + (w - 1) * c)
    return best


def _classes(ctx, wi: int):
    """Per wire the id of its value; per id its bit length and popcount."""
    key = ("msm_classes", wi)
    if key not in ctx.memo:
        index, ids = {}, []
        for x in ctx.pool.witnesses[wi]:
            ids.append(index.setdefault(int(x), len(index)))
        ctx.memo[key] = (np.asarray(ids, dtype=np.int64),
                         np.asarray([v.bit_length() for v in index], dtype=np.int64),
                         np.asarray([bin(v).count("1") for v in index], dtype=np.int64))
    return ctx.memo[key]


def _masks(ctx):
    if "msm_masks" not in ctx.memo:
        st = ctx.pool.statement()
        used = {}
        for name in ("a", "b", "c"):
            m = np.zeros(st.n_wires, dtype=bool)
            m[st.entries[name][1]] = True
            used[name] = m
        private = np.arange(st.n_wires) > st.n_public
        ctx.memo["msm_masks"] = {"a": used["a"], "b1": used["b"], "b2": used["b"],
                                 "c": private & (used["a"] | used["b"] | used["c"])}
    return ctx.memo["msm_masks"]


def msm_ops(ids, bits, ones, mask) -> float:
    """Group operations of one witness MSM over the wires in `mask`."""
    counts = np.bincount(ids[mask], minlength=len(bits))
    one = bits == 1  # the value 1 (the only one of bit length 1)
    other = bits > 1
    shared = other & (counts >= 2)
    once = other & (counts == 1)
    ops = float(counts[one].sum())
    ops += float((counts[shared] - 1 + ones[shared] - 1 + bits[shared] - 1).sum())
    return ops + pippenger_ops(bits[once])


def work(ctx, req):
    ids, bits, ones = _classes(ctx, req.wi)
    masks = _masks(ctx)
    m = ctx.pool.statement().domain
    g1 = sum(msm_ops(ids, bits, ones, masks[q]) for q in ("a", "b1", "c"))
    g1 += pippenger_ops(np.full(m - 1, FULL_BITS))
    g2 = msm_ops(ids, bits, ones, masks["b2"])
    products = G1_PRODUCTS * g1 + G2_PRODUCTS * g2
    points = sum(int(masks[q].sum()) for q in ("a", "b1", "c")) + (m - 1)
    n_bytes = 64 * points + 128 * int(masks["b2"].sum()) + 32 * (len(ids) + m - 1)
    return products * MONT_OPS, n_bytes
