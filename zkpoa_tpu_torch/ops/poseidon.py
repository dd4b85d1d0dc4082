# Copy of zkpoa_tpu/ops/poseidon.py; only its imports, and the reference repository's paths in its text, are rewritten.
"""Poseidon hash over the BN254 scalar field — host reference implementation.

Circomlib-compatible (pinned by test vectors): this is the hash used for
Merkle leaves/nodes (Poseidon(2)), the layer-1 pubkey sponge
(PoseidonSponge via PoseidonEx(16, ·)), and the layer-2 leaf hash.

The batched TPU kernel lives in zkpoa_tpu.ops.poseidon_jax and is
cross-checked against this module. Behavior matched (not copied) from the
reference: circomlib Poseidon/PoseidonEx semantics and the sponge chaining
of reference circuits/poseidon.circom:8-45 (chunks of 16 through
PoseidonEx, initialState = previous out[0], final output = last out[1]).
"""

from __future__ import annotations

from typing import List, Sequence

from ..fields.bn254 import R as P
from .poseidon_params import R_F, n_partial_rounds, poseidon_params


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
