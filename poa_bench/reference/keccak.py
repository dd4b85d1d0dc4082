"""Frozen copy of the host Keccak-256 of `zkpoa_tpu_torch/ops/keccak.py` (Ethereum padding)."""

from __future__ import annotations

from typing import List, Tuple
RATE_BYTES = 136  # 1088-bit rate for 256-bit output
ROUNDS = 24

# Standard round constants (computed by LFSR; spelled out for clarity)
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] (Keccak spec)
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def _keccak_f(lanes: List[List[int]]) -> List[List[int]]:
    a = lanes
    for rnd in range(ROUNDS):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK64) for y in range(5)]
            for x in range(5)
        ]
        # iota
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
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


def eth_address(pubkey: Tuple[int, int]) -> int:
    """keccak256(x || y as 32B big-endian each)[12:] as an int
    (circuits/eth.circom PubkeyToAddress semantics)."""
    data = pubkey[0].to_bytes(32, "big") + pubkey[1].to_bytes(32, "big")
    return int.from_bytes(keccak256(data)[12:], "big")


