"""Plain-torch arithmetic in the BN254 scalar field, on any device.

An element is 16 limbs of 16 bits held in int64, little-endian, so a
limb product is below 2^32 and a column of sixteen of them stays far
below 2^63: no operation needs a carry until the end of a product. The
Montgomery product is schoolbook multiplication followed by word-by-word
reduction (R = 2^256), then one carry pass and one conditional
subtraction. Nothing here shares code with the program under test.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .bn254 import R

LIMBS = 16
MASK = 0xFFFF
RADIX = 1 << 256
R2 = RADIX * RADIX % R
RADIX_INV = pow(RADIX, -1, R)
N0 = (-pow(R, -1, 1 << 16)) % (1 << 16)  # -r^-1 mod 2^16
CHUNK = 1 << 21  # rows a product works on at once (bounds scratch memory)

_R_LIMBS = {}


def _r_limbs(device) -> torch.Tensor:
    key = str(device)
    if key not in _R_LIMBS:
        _R_LIMBS[key] = to_limbs([R], device)[0]
    return _R_LIMBS[key]


def to_limbs(values: Sequence[int], device="cpu") -> torch.Tensor:
    """Python ints in [0, 2^256) -> [n, 16] int64 limbs on `device`."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(blob, dtype="<u2").reshape(-1, LIMBS).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def from_limbs(t: torch.Tensor) -> List[int]:
    """[n, 16] normalized limbs -> Python ints."""
    blob = t.cpu().numpy().astype("<u2").tobytes()
    return [int.from_bytes(blob[i: i + 32], "little") for i in range(0, len(blob), 32)]


def limb_sum(t: torch.Tensor) -> int:
    """Sum of the values of [n, 16] limbs, reduced mod r (exact while
    n < 2^47)."""
    cols = t.sum(0).tolist()
    return sum(int(c) << (16 * k) for k, c in enumerate(cols)) % R


def _carry(t: torch.Tensor) -> torch.Tensor:
    for j in range(t.shape[1] - 1):
        t[:, j + 1] += t[:, j] >> 16
        t[:, j] &= MASK
    return t


def _sub_r_if_ge(x: torch.Tensor) -> torch.Tensor:
    """x (normalized, below 2r) -> x mod r."""
    d = x - _r_limbs(x.device)
    for j in range(LIMBS - 1):
        d[:, j + 1] += d[:, j] >> 16
        d[:, j] &= MASK
    neg = d[:, LIMBS - 1] < 0
    return torch.where(neg[:, None], x, d)


def _mont_mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    t = torch.zeros((n, 2 * LIMBS + 1), dtype=torch.int64, device=b.device)
    for i in range(LIMBS):
        t[:, i: i + LIMBS] += a[:, i: i + 1] * b
    p = _r_limbs(b.device)
    for i in range(LIMBS):
        m = ((t[:, i] & MASK) * N0) & MASK
        t[:, i: i + LIMBS] += m[:, None] * p
        t[:, i + 1] += t[:, i] >> 16
    out = _carry(t[:, LIMBS:].contiguous())
    return _sub_r_if_ge(out[:, :LIMBS].contiguous())


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / 2^256 mod r, row by row; a may be one row for all of b.
    Inputs below r."""
    if a.shape[0] == 1 and b.shape[0] != 1:
        a = a.expand(b.shape[0], LIMBS)
    if b.shape[0] <= CHUNK:
        return _mont_mul_rows(a, b)
    return torch.cat([_mont_mul_rows(a[o: o + CHUNK], b[o: o + CHUNK])
                      for o in range(0, b.shape[0], CHUNK)])


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod r, row by row; a may be one row for all of b."""
    d = a - b
    for j in range(LIMBS - 1):
        d[:, j + 1] += d[:, j] >> 16
        d[:, j] &= MASK
    neg = d[:, LIMBS - 1] < 0
    d[:, LIMBS - 1] &= MASK
    fixed = _carry(d + _r_limbs(d.device))
    fixed[:, LIMBS - 1] &= MASK  # drops the 2^256 the borrow owed
    return torch.where(neg[:, None], fixed, d)


def to_mont(values: Sequence[int], device) -> torch.Tensor:
    """Python ints (any size) -> Montgomery limbs x * 2^256 mod r."""
    return to_limbs([int(v) % R * RADIX % R for v in values], device)


def mont_of(limbs: torch.Tensor) -> torch.Tensor:
    """Plain limbs below 2^256 -> Montgomery limbs of their value mod r
    (a product with R^2 mod r)."""
    return mont_mul(to_limbs([R2], limbs.device), limbs)


def powers(base: int, n: int, device) -> torch.Tensor:
    """Montgomery limbs of base^0 .. base^(n-1), n a power of two, by
    doubling the table n.bit_length() - 1 times."""
    out = to_mont([1], device)
    step = base % R
    while out.shape[0] < n:
        out = torch.cat([out, mont_mul(to_mont([step], device), out)])
        step = step * step % R
    return out


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """Montgomery inverses of Montgomery limbs [n, 16], n a power of two and
    no row zero: a product tree up, one inversion on the host, and the
    tree down again (3n products)."""
    levels = [x]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(mont_mul(cur[0::2].contiguous(), cur[1::2].contiguous()))
    top = from_limbs(levels[-1])[0] * RADIX_INV % R
    inv = to_mont([pow(top, -1, R)], x.device)
    for lvl in reversed(levels[:-1]):
        out = torch.empty_like(lvl)
        out[0::2] = mont_mul(inv, lvl[1::2].contiguous())
        out[1::2] = mont_mul(inv, lvl[0::2].contiguous())
        inv = out
    return inv


def domain_root(log_m: int) -> int:
    """A primitive 2^log_m-th root of unity of Fr (5 generates Fr*)."""
    return pow(5, (R - 1) >> log_m, R)


def lagrange_at(tau: int, m: int, device) -> torch.Tensor:
    """Montgomery limbs [m, 16] of L_j(tau) over the m-th roots of unity:
    (tau^m - 1) / m * w^j / (tau - w^j)."""
    w_pows = powers(domain_root(m.bit_length() - 1), m, device)
    z = (pow(tau, m, R) - 1) % R
    if z == 0:
        raise ValueError("tau lies on the domain")
    inv = batch_inverse(sub_mod(to_mont([tau], device), w_pows))
    scale = to_mont([z * pow(m, -1, R) % R], device)
    return mont_mul(scale, mont_mul(w_pows, inv))
