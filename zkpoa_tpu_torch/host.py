"""Framework-neutral host helpers, copied out of JAX modules.

Each function below is a copy of a helper that lives inside a module of
the JAX package that imports `jax` at load time; the port cannot import
those modules, so it carries its own copies. Each copy names its original.
Seeds and byte layouts are kept identical so that keys and proofs made by
the port equal the JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

from zkpoa_tpu.fields.bn254 import FR_GENERATOR, R, TWO_ADICITY

LIMB_BITS = 32
N_LIMBS = 8  # 8 x 32-bit limbs per 256-bit field element


def scalars_to_limbs_fast(scalars, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Host ints -> [N, 8] int32 arrays holding little-endian u32 limbs.

    Copy of `zkpoa_tpu/ops/msm_pallas.py:2352` `scalars_to_limbs_fast`,
    re-cut for the port's 8 x 32-bit layout (the int32 holds the u32 bit
    pattern)."""
    blob = b"".join(int(s).to_bytes(4 * n_limbs, "little") for s in scalars)
    arr = np.frombuffer(blob, dtype="<u4").reshape(len(scalars), n_limbs)
    return arr.view(np.int32).copy()


def limbs_to_ints(limbs) -> List[int]:
    """[..., 8] int32/uint32 limb array -> flat list of Python ints."""
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u4"))
    blob = arr.reshape(-1, N_LIMBS).tobytes()
    return [int.from_bytes(blob[i : i + 32], "little") for i in range(0, len(blob), 32)]


def domain_root(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in Fr.

    Copy of `zkpoa_tpu/ops/ntt.py:34` `domain_root`."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"domain 2^{log_n} exceeds 2-adicity {TWO_ADICITY}")
    return pow(FR_GENERATOR, (R - 1) >> log_n, R)


def snarkjs_coset_shift(log_n: int) -> int:
    """The coset shift snarkjs/rapidsnark use for the h-query of a 2^log_n
    domain: the primitive 2n-th root of unity (shift^n = -1).

    Copy of `zkpoa_tpu/ops/ntt.py:110` `snarkjs_coset_shift`."""
    return domain_root(log_n + 1)


def _rand_fr(seed: str, label: str) -> int:
    """Proof randomness (r, s) from a seed.

    Copy of `zkpoa_tpu/prover/prove.py:34` `_rand_fr`."""
    h = hashlib.sha256(f"zkpoa-prove|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R


def _hash_to_fr(seed: str, label: str) -> int:
    """Development-setup trapdoors (tau, alpha, ...) from a seed.

    Copy of `zkpoa_tpu/prover/setup.py:34` `_hash_to_fr`."""
    h = hashlib.sha256(f"zkpoa-srs|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R


# ---------------------------------------------------------------------------
# Keccak-256: copy of the pure-Python part of `zkpoa_tpu/ops/keccak.py:22-103`
# ---------------------------------------------------------------------------

RATE_BYTES = 136
ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def _keccak_f(lanes: List[List[int]]) -> List[List[int]]:
    a = lanes
    for rnd in range(ROUNDS):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK64) for y in range(5)]
            for x in range(5)
        ]
        a[0][0] ^= _RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    """Host Keccak-256 (Ethereum padding 0x01 / 0x80)."""
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    lanes = [[0] * 5 for _ in range(5)]
    for block_start in range(0, len(padded), RATE_BYTES):
        block = padded[block_start : block_start + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            lanes[x][y] ^= lane
        lanes = _keccak_f(lanes)
    out = bytearray()
    for i in range(4):
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


def eth_address(pubkey: Tuple[int, int]) -> int:
    """keccak256(x || y as 32B big-endian each)[12:] as an int."""
    data = pubkey[0].to_bytes(32, "big") + pubkey[1].to_bytes(32, "big")
    return int.from_bytes(keccak256(data)[12:], "big")
