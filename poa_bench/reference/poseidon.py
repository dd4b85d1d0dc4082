"""Frozen copy of the port's pure-Python Poseidon (`zkpoa_tpu_torch/ops/poseidon.py`
and its parameter generator `ops/poseidon_params.py`, without the disk
cache): circomlib's Poseidon over the BN254 scalar field, its sponge, and
the Grain-LFSR round constants and MDS matrices."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

from .bn254 import R as FIELD_MOD

P = FIELD_MOD

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
    """(round_constants, mds) for width t: constants t*(R_F+R_P) in round
    order, mds t x t."""
    r_p = n_partial_rounds(t)
    g = _Grain(t, R_F, r_p)
    consts = tuple(g.field_element(rejection=True) for _ in range(t * (R_F + r_p)))
    xs = [g.field_element(rejection=False) for _ in range(t)]
    ys = [g.field_element(rejection=False) for _ in range(t)]
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % FIELD_MOD, -1, FIELD_MOD) for j in range(t))
        for i in range(t)
    )
    return consts, mds


def _permute(state: List[int], t: int) -> List[int]:
    consts, mds = poseidon_params(t)
    r_p = n_partial_rounds(t)
    r_f_half = R_F // 2
    rcc = 0
    for r in range(R_F + r_p):
        state = [(state[i] + consts[rcc + i]) % P for i in range(t)]
        rcc += t
        if r < r_f_half or r >= r_f_half + r_p:
            state = [pow(s, 5, P) for s in state]
        else:
            state[0] = pow(state[0], 5, P)
        state = [sum(mds[i][j] * state[j] for j in range(t)) % P for i in range(t)]
    return state


def poseidon_ex(inputs: Sequence[int], initial_state: int = 0, n_outs: int = 1) -> List[int]:
    """circomlib PoseidonEx: state = [initial_state, *inputs], permute,
    return the first n_outs state cells."""
    t = len(inputs) + 1
    state = [initial_state % P] + [x % P for x in inputs]
    state = _permute(state, t)
    return state[:n_outs]


def poseidon(inputs: Sequence[int]) -> int:
    """circomlib Poseidon: PoseidonEx with zero initial state, out[0]."""
    return poseidon_ex(inputs, 0, 1)[0]


def poseidon2(a: int, b: int) -> int:
    """The Merkle node/leaf hash Poseidon(2)."""
    return poseidon((a, b))


def poseidon_sponge(inputs: Sequence[int]) -> int:
    """Arbitrary-length sponge matching circuits/poseidon.circom:8-45."""
    if not inputs:
        raise ValueError("empty sponge input")
    chunk = 16
    num_rounds = (len(inputs) + chunk - 1) // chunk
    state0 = 0
    for i in range(num_rounds):
        part = inputs[i * chunk : (i + 1) * chunk]
        last = i == num_rounds - 1
        outs = poseidon_ex(part, state0, 2 if last else 1)
        if last:
            return outs[1]
        state0 = outs[0]
    raise AssertionError("unreachable")
