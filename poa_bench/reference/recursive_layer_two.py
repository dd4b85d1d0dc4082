"""Public values of LayerTwo(n, h) from its seeds: the batch's balance sum,
then the Poseidon Merkle root of the anonymity set (leaf Poseidon(address,
balance), zero leaves up to 2^(h-1)); upstream circuits/layer_two.circom."""

from __future__ import annotations

from typing import List

from .. import fixtures
from .poseidon import poseidon2


def merkle_root(rows, height: int) -> int:
    level = [poseidon2(a, b) for a, b in rows]
    level += [0] * ((1 << (height - 1)) - len(level))
    memo = {}
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            pair = (level[i], level[i + 1])
            if pair not in memo:
                memo[pair] = poseidon2(*pair)
            nxt.append(memo[pair])
        level = nxt
    return level[0]


def expected_publics(raw: dict) -> List[int]:
    balances = [k % 1000 for k in fixtures.private_keys(raw["n_sigs"], raw["sig_seed"])]
    rows = fixtures.anon_set(fixtures.signatures(raw["n_sigs"], raw["sig_seed"]),
                             raw["anon_size"], raw["anon_seed"])
    return [sum(balances), merkle_root(rows, raw["height"])]
