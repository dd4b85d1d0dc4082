"""Signature-set parsing: ECDSA -> ECDSA* with address checks.

Port of `zkpoa_tpu/pipeline/sigs.py` (`parse_signatures`, `layer_one_input`),
which reaches JAX through `ops/keccak.py`; the port derives addresses with
its host copy of Keccak-256 (`host.eth_address`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

from ..fields import secp256k1
from ..host import eth_address
from ..utils import serde


@dataclass
class AccountAttestation:
    signature: secp256k1.EcdsaStarSignature
    address: int
    balance: int


def _parse_hex_or_dec(s) -> int:
    if isinstance(s, int):
        return s
    s = str(s).rstrip("n")
    return int(s, 16) if s.startswith("0x") else int(s)


def parse_signature_entry(entry: dict) -> AccountAttestation:
    sig = entry["signature"]
    v = int(sig["v"])
    if v not in (27, 28):
        raise ValueError(f"v must be 27 or 28, got {v}")
    r = _parse_hex_or_dec(sig["r"])
    s = _parse_hex_or_dec(sig["s"])
    msghash = _parse_hex_or_dec(sig["msghash"])
    address = _parse_hex_or_dec(entry["address"])
    balance = _parse_hex_or_dec(entry["balance"])
    pubkey = secp256k1.recover_pubkey(r, s, msghash, v - 27)
    derived = eth_address(pubkey)
    if derived != address:
        raise ValueError(
            f"signature does not belong to address {hex(address)} (recovered {hex(derived)})"
        )
    star = secp256k1.ecdsa_star_from_ecdsa(r, s, msghash, pubkey)
    return AccountAttestation(signature=star, address=address, balance=balance)


def parse_signatures(entries: List[dict]) -> List[AccountAttestation]:
    """Parse, check and sort by address (layer two needs ascending order)."""
    out = [parse_signature_entry(e) for e in entries]
    out.sort(key=lambda a: a.address)
    for prev, cur in zip(out, out[1:]):
        if prev.address == cur.address:
            raise ValueError(f"duplicate address {hex(cur.address)}")
    return out


def parse_signatures_file(path: str) -> List[AccountAttestation]:
    with open(path) as f:
        return parse_signatures(json.load(f))


def layer_one_input(attestations: List[AccountAttestation]) -> dict:
    """Layer-1 circuit signal JSON: 4 x 64-bit register arrays per signal."""
    regs = serde.to_limbs_64x4
    return {
        "r": [[str(x) for x in regs(a.signature.r)] for a in attestations],
        "s": [[str(x) for x in regs(a.signature.s)] for a in attestations],
        "rprime": [[str(x) for x in regs(a.signature.r_prime)] for a in attestations],
        "msghash": [[str(x) for x in regs(a.signature.msghash)] for a in attestations],
        "pubkey": [
            [
                [str(x) for x in regs(a.signature.pubkey[0])],
                [str(x) for x in regs(a.signature.pubkey[1])],
            ]
            for a in attestations
        ],
    }
