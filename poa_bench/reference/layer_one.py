"""Public values of LayerOne(n) from its seed: the Poseidon sponge of the
batch's public-key x-coordinates as 4 x 64-bit little-endian registers,
signatures in ascending address order (upstream circuits/layer_one.circom)."""

from __future__ import annotations

from typing import List

from .. import fixtures
from . import secp256k1 as S
from .keccak import eth_address
from .poseidon import poseidon_sponge


def sorted_pubkeys(n: int, seed: str):
    pubs = [S.pubkey_from_private(k) for k in fixtures.private_keys(n, seed)]
    return sorted(pubs, key=eth_address)


def registers(x: int) -> List[int]:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]


def expected_publics(raw: dict) -> List[int]:
    regs = [v for pub in sorted_pubkeys(raw["n_sigs"], raw["sig_seed"]) for v in registers(pub[0])]
    return [poseidon_sponge(regs)]
