# Copy of zkpoa_tpu/models/gadgets/poseidon_gadget.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Poseidon permutation as R1CS constraints (circomlib-compatible params).

Same math as the host/TPU kernels (zkpoa_tpu.ops.poseidon*): ark and MDS
mixing are linear (absorbed into LCs, zero constraints); each x^5 S-box
costs 3 multiplication constraints. The in-circuit hash therefore equals
the out-of-circuit hash bit for bit — the property the reference relies on
when layer-2 re-hashes pubkeys and Merkle nodes in-snark (circuits/
layer_two.circom:54-65,101-113).
"""

from __future__ import annotations

from typing import List, Sequence

from ...fields.bn254 import R as P
from ...ops.poseidon_params import R_F, n_partial_rounds, poseidon_params
from ..r1cs import LC, AnyLC, Circuit, Signal, _lc


def _sbox(c: Circuit, x: AnyLC) -> Signal:
    x2 = c.mul(x, x)
    x4 = c.mul(x2, x2)
    return c.mul(x4, x)


def poseidon_permute(c: Circuit, state: Sequence[AnyLC]) -> List[LC]:
    """Full permutation on a t-element state of LCs; returns new state LCs."""
    t = len(state)
    consts, mds = poseidon_params(t)
    r_p = n_partial_rounds(t)
    half = R_F // 2
    st = [_lc(s) for s in state]
    rcc = 0
    for r in range(R_F + r_p):
        st = [st[i] + consts[rcc + i] for i in range(t)]
        rcc += t
        if r < half or r >= half + r_p:
            st = [_sbox(c, s) for s in st]
        else:
            st = [_sbox(c, st[0])] + st[1:]
        st = [
            sum((st[j] * mds[i][j] for j in range(t)), LC.const(0)) for i in range(t)
        ]
    return st


def poseidon_ex(c: Circuit, inputs: Sequence[AnyLC], initial_state: AnyLC = 0, n_outs: int = 1) -> List[LC]:
    state = [_lc(initial_state)] + [_lc(x) for x in inputs]
    return poseidon_permute(c, state)[:n_outs]


def poseidon(c: Circuit, inputs: Sequence[AnyLC]) -> LC:
    return poseidon_ex(c, inputs, 0, 1)[0]


def poseidon_sponge(c: Circuit, inputs: Sequence[AnyLC]) -> LC:
    """PoseidonSponge over arbitrary length (circuits/poseidon.circom:8-45)."""
    chunk = 16
    num_rounds = (len(inputs) + chunk - 1) // chunk
    state0: AnyLC = 0
    for i in range(num_rounds):
        part = inputs[i * chunk : (i + 1) * chunk]
        last = i == num_rounds - 1
        outs = poseidon_ex(c, part, state0, 2 if last else 1)
        if last:
            return outs[1]
        state0 = outs[0]
    raise AssertionError("unreachable")
