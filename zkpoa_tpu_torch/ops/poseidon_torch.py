"""Batched Poseidon permutation on torch tensors (BN254 Fr).

Port of `zkpoa_tpu/ops/poseidon_jax.py` (`_params_mont` :30, `permute`
:57, `hash2` :97, `sponge_batch` :105, `poseidon_many` :127): the hot path
of the Merkle engine. State is [B, t, 8] int32 Montgomery limbs; every
product and sum goes through `limbs.mont_mul` / `limbs.add_mod`, which
launch kernel B1 on CUDA tensors and run the plain versions on CPU
tensors. A round is one batched add of its constants, x^5 on the whole
state (full rounds) or on its first cell (partial rounds), and the MDS mix
as one broadcast product [B, t, t] plus t - 1 sums. The parameters are the
circomlib-compatible ones of `poseidon_params`, put into Montgomery form
once per device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import limbs as L
from .limbs import BN254_FR
from .poseidon_params import R_F, n_partial_rounds, poseidon_params

_PARAMS: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _params_mont(t: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round constants [R_F + R_P, t, 8] and MDS [t, t, 8], Montgomery."""
    key = (t, str(device))
    if key not in _PARAMS:
        consts, mds = poseidon_params(t)
        n_rounds = R_F + n_partial_rounds(t)
        spec = BN254_FR
        c = spec.encode(consts[: n_rounds * t], device).reshape(n_rounds, t, 8)
        m = spec.encode([x for row in mds for x in row], device).reshape(t, t, 8)
        _PARAMS[key] = (c, m)
    return _PARAMS[key]


def _pow5(x: torch.Tensor) -> torch.Tensor:
    spec = BN254_FR
    x2 = L.mont_mul(spec, x, x)
    return L.mont_mul(spec, L.mont_mul(spec, x2, x2), x)


def _mix(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """new[i] = sum_j M[i][j] * s[j]; state [B, t, 8]."""
    spec = BN254_FR
    b, t = state.shape[0], state.shape[1]
    prod = L.mont_mul(spec, state[:, None, :, :].expand(b, t, t, 8), mds)  # [B, i, j, 8]
    acc = prod[:, :, 0, :]
    for j in range(1, t):
        acc = L.add_mod(spec, acc, prod[:, :, j, :])
    return acc


def permute(t: int, state: torch.Tensor) -> torch.Tensor:
    """Full Poseidon permutation of state [B, t, 8] (Montgomery limbs)."""
    spec = BN254_FR
    consts, mds = _params_mont(t, state.device)
    r_p = n_partial_rounds(t)
    half = R_F // 2
    for r in range(R_F + r_p):
        state = L.add_mod(spec, state, consts[r])
        if r < half or r >= half + r_p:
            state = _pow5(state)
        else:
            state = torch.cat([_pow5(state[:, :1, :]), state[:, 1:, :]], dim=1)
        state = _mix(state, mds)
    return state


def poseidon_ex_batch(inputs: torch.Tensor, initial_state: torch.Tensor,
                      n_outs: int = 1) -> torch.Tensor:
    """circomlib PoseidonEx, batched: inputs [B, n, 8], initial_state
    [B, 8] -> [B, n_outs, 8] (Montgomery limbs)."""
    state = torch.cat([initial_state[:, None, :], inputs], dim=1)
    return permute(state.shape[1], state)[:, :n_outs, :]


def hash2(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Poseidon(2), the Merkle leaf and node hash: [B, 8] x [B, 8] -> [B, 8]."""
    state = torch.stack([torch.zeros_like(left), left, right], dim=1)
    return permute(3, state)[:, 0, :]


def sponge_batch(inputs: torch.Tensor) -> torch.Tensor:
    """PoseidonSponge (circuits/poseidon.circom), batched: [B, L, 8] -> [B, 8]."""
    b, length, _ = inputs.shape
    chunk = 16
    num_rounds = (length + chunk - 1) // chunk
    state0 = torch.zeros((b, 8), dtype=torch.int32, device=inputs.device)
    for i in range(num_rounds):
        part = inputs[:, i * chunk : (i + 1) * chunk, :]
        if i == num_rounds - 1:
            return poseidon_ex_batch(part, state0, 2)[:, 1, :]
        state0 = poseidon_ex_batch(part, state0, 1)[:, 0, :]
    raise ValueError("empty sponge input")


def poseidon_many(rows, device) -> list:
    """rows: [B][n] Python ints -> [B] ints, one batched permutation."""
    spec = BN254_FR
    rows = [list(r) for r in rows]
    enc = spec.encode([x for r in rows for x in r], device).reshape(len(rows), len(rows[0]), 8)
    zero = torch.zeros((len(rows), 8), dtype=torch.int32, device=device)
    return spec.decode(poseidon_ex_batch(enc, zero, 1)[:, 0, :])
