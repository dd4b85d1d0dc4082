"""Keccak-256 (pre-NIST padding 0x01, the Ethereum variant): the host
reference and the batched device version.

Port of `zkpoa_tpu/ops/keccak.py`. Used for pubkey -> Ethereum address
derivation (keccak256(pubkey_xy_64B)[12:]). The host half (`keccak256`,
`eth_address` and the constants the circuit gadget shares) is that file's
pure-Python code, unchanged. The batch half is plain torch on a device,
bit-parallel over the batch like the JAX package's XLA code (no
`pallas_call` there, so none here): each 64-bit lane is a (hi, lo) pair of
32-bit halves, and theta, rho, pi, chi and iota are whole-tensor ops over
[B, 25] lanes, lane i = x + 5y. CPU torch's uint32 has no +, - or >>, so
the halves live in int64, masked to 32 bits after every left shift and
every ~; a right shift of a masked value is then exact.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Batched device version: fixed-length single-block messages
# ---------------------------------------------------------------------------


def _keccak_tables():
    """Per flat lane i = x + 5y: its rotation (rho), the source lane pi
    moves into it, its chi neighbours (x + 1, y) and (x + 2, y), and the
    round constants' halves."""
    rot = np.zeros(25, dtype=np.int64)
    pi_src = np.zeros(25, dtype=np.int64)
    for x in range(5):
        for y in range(5):
            # b[y][(2x + 3y) % 5] = rotl(a[x][y]): dest x_d = y, y_d = (2x + 3y) % 5
            rot[(2 * x + 3 * y) % 5 * 5 + y] = _ROT[x][y]
            pi_src[((2 * x + 3 * y) % 5) * 5 + y] = y * 5 + x
    idx = np.arange(25)
    xs, ys = idx % 5, idx // 5
    chi1 = ((xs + 1) % 5 + 5 * ys).astype(np.int64)
    chi2 = ((xs + 2) % 5 + 5 * ys).astype(np.int64)
    rc_hi = np.array([rc >> 32 for rc in _RC], dtype=np.int64)
    rc_lo = np.array([rc & _MASK32 for rc in _RC], dtype=np.int64)
    return rot, pi_src, chi1, chi2, rc_hi, rc_lo


_ROT_FLAT, _PI_SRC, _CHI1, _CHI2, _RC_HI, _RC_LO = _keccak_tables()


def _rotl64_vec(hi: torch.Tensor, lo: torch.Tensor, n: torch.Tensor):
    """Rotate-left 64-bit lanes (hi, lo: int64 [..., L] holding 32-bit
    halves) by per-lane amounts n (int64 [L], in [0, 64))."""
    a = n % 32
    swap = (n // 32) % 2 == 1
    a_safe = torch.clamp(a, min=1)  # a == 0 takes nothing from the other half
    zero = torch.zeros((), dtype=hi.dtype, device=hi.device)
    h1 = ((hi << a) & _MASK32) | torch.where(a == 0, zero, lo >> (32 - a_safe))
    l1 = ((lo << a) & _MASK32) | torch.where(a == 0, zero, hi >> (32 - a_safe))
    return torch.where(swap, l1, h1), torch.where(swap, h1, l1)


def _keccak_f_flat(hi: torch.Tensor, lo: torch.Tensor):
    """One Keccak-f[1600] permutation. hi/lo: int64 [B, 25] 32-bit halves,
    lane i = x + 5y."""
    dev = hi.device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    rot, pi_src, chi1, chi2 = t(_ROT_FLAT), t(_PI_SRC), t(_CHI1), t(_CHI2)
    rc_hi, rc_lo = _RC_HI.tolist(), _RC_LO.tolist()
    b = hi.shape[0]
    for r in range(ROUNDS):
        # theta
        g_hi, g_lo = hi.view(b, 5, 5), lo.view(b, 5, 5)  # [B, y, x]
        c_hi = g_hi[:, 0] ^ g_hi[:, 1] ^ g_hi[:, 2] ^ g_hi[:, 3] ^ g_hi[:, 4]
        c_lo = g_lo[:, 0] ^ g_lo[:, 1] ^ g_lo[:, 2] ^ g_lo[:, 3] ^ g_lo[:, 4]
        # d[x] = c[x-1] ^ rotl1(c[x+1])
        r_hi = ((c_hi << 1) & _MASK32) | (c_lo >> 31)
        r_lo = ((c_lo << 1) & _MASK32) | (c_hi >> 31)
        d_hi = torch.roll(c_hi, 1, dims=-1) ^ torch.roll(r_hi, -1, dims=-1)
        d_lo = torch.roll(c_lo, 1, dims=-1) ^ torch.roll(r_lo, -1, dims=-1)
        hi = hi ^ d_hi.repeat(1, 5)
        lo = lo ^ d_lo.repeat(1, 5)
        # rho + pi: gather source lanes, then rotate by dest-lane amounts
        hi, lo = _rotl64_vec(hi[:, pi_src], lo[:, pi_src], rot)
        # chi
        hi = hi ^ ((~hi[:, chi1] & _MASK32) & hi[:, chi2])
        lo = lo ^ ((~lo[:, chi1] & _MASK32) & lo[:, chi2])
        # iota
        hi[:, 0] ^= rc_hi[r]
        lo[:, 0] ^= rc_lo[r]
    return hi, lo


def keccak_f_batch(state: torch.Tensor) -> torch.Tensor:
    """state: [B, 5, 5, 2] 32-bit halves of each lane [x][y], [..., 0] the
    high half. One full Keccak-f[1600] permutation, batched, on the state's
    device; returns int64 [B, 5, 5, 2]."""
    b = state.shape[0]
    state = state.to(torch.int64) & _MASK32
    # [B, x, y, 2] -> flat lane axis i = x + 5y
    hi = state[..., 0].transpose(1, 2).reshape(b, 25)
    lo = state[..., 1].transpose(1, 2).reshape(b, 25)
    hi, lo = _keccak_f_flat(hi, lo)
    out = torch.stack([hi.view(b, 5, 5), lo.view(b, 5, 5)], dim=-1)
    return out.transpose(1, 2).contiguous()


def keccak256_fixed_batch(msgs, device="cuda") -> torch.Tensor:
    """Batched Keccak-256 of equal-length messages (< RATE_BYTES, one
    block) on `device`. msgs: uint8 [B, L] (numpy or torch) -> uint8
    [B, 32] on `device`."""
    if not torch.is_tensor(msgs):
        msgs = torch.from_numpy(np.array(msgs, dtype=np.uint8))
    msgs = msgs.to(device)
    b, length = msgs.shape
    assert length < RATE_BYTES, "single-block only"
    padded = torch.zeros((b, RATE_BYTES), dtype=torch.int64, device=device)
    padded[:, :length] = msgs.to(torch.int64)
    padded[:, length] ^= 0x01
    padded[:, -1] ^= 0x80
    # bytes -> lanes (little-endian 64-bit); absorbed lane i sits at flat i = x + 5y
    lanes = padded.view(b, RATE_BYTES // 8, 8)
    shifts = torch.arange(4, device=device, dtype=torch.int64) * 8
    hi = torch.zeros((b, 25), dtype=torch.int64, device=device)
    lo = torch.zeros((b, 25), dtype=torch.int64, device=device)
    lo[:, : RATE_BYTES // 8] = (lanes[:, :, :4] << shifts).sum(-1)
    hi[:, : RATE_BYTES // 8] = (lanes[:, :, 4:] << shifts).sum(-1)
    hi, lo = _keccak_f_flat(hi, lo)
    # the first 4 lanes, little-endian: bytes 8i .. 8i + 3 from lo, 8i + 4 .. 8i + 7 from hi
    out = torch.stack([lo[:, :4, None] >> shifts, hi[:, :4, None] >> shifts], dim=2) & 0xFF
    return out.reshape(b, 32).to(torch.uint8)


def eth_addresses_batch(pubkeys: Sequence[Tuple[int, int]], device="cuda") -> List[int]:
    """Batched pubkey -> address derivation on `device`."""
    blob = b"".join(x.to_bytes(32, "big") + y.to_bytes(32, "big") for x, y in pubkeys)
    msgs = np.frombuffer(blob, dtype=np.uint8).reshape(len(pubkeys), 64)
    digests = keccak256_fixed_batch(msgs, device).cpu().numpy()
    return [int.from_bytes(d[12:].tobytes(), "big") for d in digests]
