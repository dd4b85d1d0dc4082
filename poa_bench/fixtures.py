"""Seeded inputs: signature batches and anonymity sets.

The logic of the port's `pipeline/fixtures.py` (the role of upstream's
tests/generate_ecdsa_signatures.ts and tests/generate_anon_set.ts), frozen
here with its own secp256k1 and Keccak so that the inputs cannot move
with the program: keys hashed from a seed, balances `key % 1000`,
signatures over one message, entries sorted by address, and filler
addresses hashed from the seed. The same seed gives the same entries.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from .reference import secp256k1 as S
from .reference.keccak import eth_address, keccak256

MESSAGE = b"zkpoa proof of assets attestation"


def _det_int(seed: str, label: str) -> int:
    return int.from_bytes(hashlib.sha256(f"zkpoa-fixture|{seed}|{label}".encode()).digest(), "big")


def private_keys(n: int, seed: str) -> List[int]:
    return [_det_int(seed, f"pvt|{i}") % (S.N - 1) + 1 for i in range(n)]


def signatures(n: int, seed: str) -> List[dict]:
    """n signature entries in upstream's signatures.json shape
    ({signature: {v, r, s, msghash}, address, balance}), sorted by address."""
    msghash = int.from_bytes(keccak256(MESSAGE), "big")
    entries = []
    for i, pvt in enumerate(private_keys(n, seed)):
        pub = S.pubkey_from_private(pvt)
        nonce = _det_int(seed, f"nonce|{i}") % (S.N - 1) + 1
        r, s = S.ecdsa_sign(pvt, msghash, nonce)
        v = 27 if S.recover_pubkey(r, s, msghash, 0) == pub else 28
        entries.append({
            "signature": {"v": v, "r": hex(r), "s": hex(s), "msghash": hex(msghash)},
            "address": hex(eth_address(pub)),
            "balance": str(pvt % 1000),
        })
    entries.sort(key=lambda e: int(e["address"], 16))
    return entries


def anon_set(owned: List[dict], size: int, seed: str) -> List[Tuple[int, int]]:
    """`size` (address, balance) rows, ascending: every owned address with
    its balance, then filler addresses hashed from the seed."""
    rows = {int(e["address"], 16): int(e["balance"]) for e in owned}
    i = 0
    while len(rows) < size:
        addr = _det_int(seed, f"addr|{i}") % (1 << 160)
        i += 1
        if addr not in rows:
            rows[addr] = _det_int(seed, f"bal|{i}") % 10**6
    return sorted(rows.items())
