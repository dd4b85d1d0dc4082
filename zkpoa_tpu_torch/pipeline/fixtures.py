# Copy of zkpoa_tpu/pipeline/fixtures.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Deterministic test-fixture generation: signature sets and anonymity sets.

Role of the reference's tests/generate_ecdsa_signatures.ts,
tests/generate_anon_set.ts and tests/keys.ts (SURVEY.md §2.7) — but keys are
derived from a seed by hashing instead of a hardcoded 600-key table, and
balances follow the same `pvt % 1000` convention (tests/keys.ts:636-638).
Signatures are sorted by address (the layer-2 circuit requires strictly
ascending addresses, tests/generate_ecdsa_signatures.ts:59-66)."""

from __future__ import annotations

import csv
import hashlib
import json
from typing import List, Optional, Tuple

from ..fields import secp256k1 as S
from ..ops.keccak import eth_address, keccak256

DEFAULT_MESSAGE = b"zkpoa proof of assets attestation"


def _det_int(seed: str, label: str, n_bytes: int = 32) -> int:
    h = hashlib.sha256(f"zkpoa-fixture|{seed}|{label}".encode()).digest()
    return int.from_bytes(h[:n_bytes], "big")


def deterministic_keys(n: int, seed: str = "keys") -> List[int]:
    """n deterministic secp256k1 private keys."""
    out = []
    for i in range(n):
        k = _det_int(seed, f"pvt|{i}") % (S.N - 1) + 1
        out.append(k)
    return out


def generate_signatures(
    n: int,
    seed: str = "keys",
    message: bytes = DEFAULT_MESSAGE,
) -> List[dict]:
    """SignatureData[] entries (the reference signatures.json shape:
    {signature: {v, r, s, msghash}, address, balance}), sorted by address."""
    msghash = int.from_bytes(keccak256(message), "big")
    entries = []
    for i, pvt in enumerate(deterministic_keys(n, seed)):
        pub = S.pubkey_from_private(pvt)
        nonce = _det_int(seed, f"nonce|{i}") % (S.N - 1) + 1
        r, s = S.ecdsa_sign(pvt, msghash, nonce)
        # recovery id: recover with both parities and compare
        rec = S.recover_pubkey(r, s, msghash, 0)
        v = 27 if rec == pub else 28
        assert S.recover_pubkey(r, s, msghash, v - 27) == pub
        addr = eth_address(pub)
        entries.append(
            {
                "signature": {
                    "v": v,
                    "r": hex(r),
                    "s": hex(s),
                    "msghash": hex(msghash),
                },
                "address": hex(addr),
                "balance": str(pvt % 1000),
            }
        )
    entries.sort(key=lambda e: int(e["address"], 16))
    return entries


def generate_anon_set(
    owned_entries: List[dict],
    extra: int = 100,
    seed: str = "anon",
) -> List[Tuple[int, int]]:
    """(address, balance) rows: every owned address (exact balances) plus
    `extra` deterministic filler addresses, sorted ascending."""
    rows = {int(e["address"], 16): int(e["balance"]) for e in owned_entries}
    i = 0
    while len(rows) < len(owned_entries) + extra:
        addr = _det_int(seed, f"addr|{i}") % (1 << 160)
        i += 1
        if addr in rows:
            continue
        rows[addr] = _det_int(seed, f"bal|{i}") % 10**6
    return sorted(rows.items())


def write_fixtures(
    n_sigs: int,
    sigs_path: str,
    anon_path: str,
    extra: int = 100,
    seed: str = "keys",
) -> None:
    entries = generate_signatures(n_sigs, seed=seed)
    with open(sigs_path, "w") as f:
        json.dump(entries, f, indent=1)
    with open(anon_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["address", "balance"])
        for addr, bal in generate_anon_set(entries, extra=extra, seed=seed):
            w.writerow([f"0x{addr:040x}", bal])
