# Copy of zkpoa_tpu/ops/poseidon_params.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Poseidon parameter generation (circomlib-compatible, BN254 scalar field).

Round constants and MDS matrices are derived from the Grain-LFSR procedure of
the Poseidon reference implementation, with the exact variant circomlib uses
(pinned by test vectors, tests/test_poseidon.py):

  * Grain state seeded with (field=1, sbox=0, n=254, t, R_F, R_P, 30x'1'),
    each field MSB-first in 80 bits; 160 warm-up updates; shrinking output
    (of each bit pair, emit the 2nd iff the 1st is 1).
  * Round constants: 254-bit samples MSB-first, rejection-sampled below r.
  * MDS: x_0..x_{t-1}, y_0..y_{t-1} drawn as 254-bit samples *without*
    rejection (reduced mod r); M[i][j] = (x_i + y_j)^-1; state mixing is
    new[i] = sum_j M[i][j] * old[j].

R_F = 8 for all t; R_P per t follows the circomlib table. This replaces the
reference's dependence on circomlib's poseidon_constants.json (vendored
submodule, SURVEY.md §2.2) with a from-scratch generator — same math, no
copied tables. Constants are cached in-process and memoized to disk (npz)
because generation is pure-Python bit twiddling.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Tuple

from ..fields.bn254 import R as FIELD_MOD

R_F = 8
# t = 2..17 (i.e. 1..16 inputs), circomlib partial-round counts
R_P_TABLE = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
N_BITS = 254
MAX_T = 17


def n_partial_rounds(t: int) -> int:
    if not 2 <= t <= MAX_T:
        raise ValueError(f"unsupported poseidon width t={t}")
    return R_P_TABLE[t - 2]


class _Grain:
    __slots__ = ("state",)

    def __init__(self, t: int, r_f: int, r_p: int):
        bits: List[int] = []
        for val, width in ((1, 2), (0, 4), (N_BITS, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [int(b) for b in format(val, f"0{width}b")]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        nb = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(nb)
        return nb

    def next_bit(self) -> int:
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1:
                return b2

    def random_bits(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.next_bit()
        return x

    def field_element(self, rejection: bool) -> int:
        while True:
            x = self.random_bits(N_BITS)
            if not rejection:
                return x % FIELD_MOD
            if x < FIELD_MOD:
                return x


@lru_cache(maxsize=None)
def poseidon_params(t: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """Return (round_constants, mds) for width t. Constants are length
    t*(R_F+R_P) in round order; mds is t x t."""
    r_p = n_partial_rounds(t)
    cache = _disk_cache_path(t)
    if cache and os.path.exists(cache):
        import numpy as np

        data = np.load(cache, allow_pickle=False)
        consts = tuple(int(x) for x in data["c"])
        mds = tuple(tuple(int(x) for x in row) for row in data["m"])
        return consts, mds

    g = _Grain(t, R_F, r_p)
    consts = tuple(g.field_element(rejection=True) for _ in range(t * (R_F + r_p)))
    xs = [g.field_element(rejection=False) for _ in range(t)]
    ys = [g.field_element(rejection=False) for _ in range(t)]
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % FIELD_MOD, -1, FIELD_MOD) for j in range(t))
        for i in range(t)
    )
    if cache:
        try:
            import numpy as np

            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.savez(
                cache,
                c=np.array([str(x) for x in consts]),
                m=np.array([[str(x) for x in row] for row in mds]),
            )
        except OSError:
            pass
    return consts, mds


def _disk_cache_path(t: int) -> str:
    base = os.environ.get(
        "ZKPOA_CACHE_DIR", os.path.join(os.path.dirname(__file__), "_cache")
    )
    return os.path.join(base, f"poseidon_t{t}.npz")
