# Copy of zkpoa_tpu/utils/serde.py; only its imports, and the reference repository's paths in its text, are rewritten.
"""Serialization helpers: the reference's JSON conventions and the register
(limb) layouts shared by host code, circuits, and TPU kernels.

JSON bigint tagging matches reference scripts/lib/json_serde.ts:12-45:
bigints serialize as {"__bigint__": "<decimal>"} and Uint8Arrays as
{"__uint8array__": [..]}. Circuit signal JSON (snarkjs-style) instead uses
plain decimal strings; both are supported.

Canonical limb layouts (little-endian, decimal-string in JSON):
  * secp256k1 field/scalars: 4 x 64-bit   (reference scripts/lib/utils.ts:4-14)
  * BN254 in-circuit:        6 x 43-bit   (sanitize_groth16_proof.py:113-114)
  * Curve25519:              3 x 85-bit   (pedersen_commitment.ts:163-177)
"""

from __future__ import annotations

import json
from typing import Any, List, Sequence

# ---------------------------------------------------------------------------
# Limb (register) conversions
# ---------------------------------------------------------------------------


def to_limbs(x: int, bits: int, k: int) -> List[int]:
    """Split x into k little-endian limbs of `bits` bits each."""
    if x < 0:
        raise ValueError("negative value")
    mask = (1 << bits) - 1
    out = []
    for _ in range(k):
        out.append(x & mask)
        x >>= bits
    if x:
        raise ValueError(f"value does not fit in {k}x{bits} bits")
    return out


def from_limbs(limbs: Sequence[int], bits: int) -> int:
    x = 0
    for limb in reversed(list(limbs)):
        x = (x << bits) | int(limb)
    return x


def to_limbs_64x4(x: int) -> List[int]:
    return to_limbs(x, 64, 4)


def to_limbs_43x6(x: int) -> List[int]:
    return to_limbs(x, 43, 6)


def to_limbs_85x3(x: int) -> List[int]:
    return to_limbs(x, 85, 3)


def from_limbs_64x4(limbs: Sequence[int]) -> int:
    return from_limbs(limbs, 64)


def from_limbs_43x6(limbs: Sequence[int]) -> int:
    return from_limbs(limbs, 43)


def from_limbs_85x3(limbs: Sequence[int]) -> int:
    return from_limbs(limbs, 85)


# ---------------------------------------------------------------------------
# JSON with __bigint__ / __uint8array__ tagging
# ---------------------------------------------------------------------------


def _encode(obj: Any) -> Any:
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return {"__bigint__": str(obj)}
    if isinstance(obj, bytes):
        return {"__uint8array__": list(obj)}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__bigint__"}:
            return int(obj["__bigint__"])
        if set(obj.keys()) == {"__uint8array__"}:
            return bytes(obj["__uint8array__"])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def dumps_tagged(obj: Any, **kw: Any) -> str:
    return json.dumps(_encode(obj), **kw)


def loads_tagged(s: str) -> Any:
    return _decode(json.loads(s))


def load_tagged(path: str) -> Any:
    with open(path) as f:
        return _decode(json.load(f))


def dump_tagged(obj: Any, path: str, **kw: Any) -> None:
    with open(path, "w") as f:
        json.dump(_encode(obj), f, **kw)


# ---------------------------------------------------------------------------
# snarkjs-style signal JSON (decimal strings, arbitrarily nested lists)
# ---------------------------------------------------------------------------


def signals_to_json(obj: Any) -> Any:
    """ints -> decimal strings, recursively (snarkjs input/proof convention)."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return str(obj)
    if isinstance(obj, dict):
        return {k: signals_to_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [signals_to_json(v) for v in obj]
    return obj


def signals_from_json(obj: Any) -> Any:
    """decimal strings -> ints, recursively."""
    if isinstance(obj, str):
        return int(obj)
    if isinstance(obj, dict):
        return {k: signals_from_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [signals_from_json(v) for v in obj]
    return obj


def load_signals(path: str) -> Any:
    with open(path) as f:
        return signals_from_json(json.load(f))


def dump_signals(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(signals_to_json(obj), f)
