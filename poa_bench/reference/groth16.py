"""The plain reference of a Groth16 prove under a development key, and a
plain verifier of recorded proofs.

A development key is made from trapdoors (tau, alpha, beta, gamma, delta)
that a seed fixes, so the proof of a witness with randomness (r, s) is
known as three scalars times the generators:

    pi_a = (alpha + A + r delta) G1
    pi_b = (beta + B + s delta) G2
    pi_c = ((K + A B - C) / delta + s a + r b - r s delta) G1

where A, B, C are the QAP polynomials of the witness at tau,
A(tau) = sum_j <A_j, w> L_j(tau) over the m-th roots of unity (m the
power of two at or above the constraint count), K is the private wires'
share beta A + alpha B + C, and A B - C = h(tau) Z(tau) because the
witness satisfies the system. This module works those scalars out from
the constraint system, the witness and the seed alone, with the sums over
the constraints in plain torch on a device (`fr`) and the rest in Python
integers, and never reads the program's key or any table it made.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import bn254, fr
from .bn254 import R

ENTRY_CHUNK = 1 << 21  # constraint entries a step of the sums works on


def dev_trapdoor(seed: str, label: str) -> int:
    """A trapdoor of the development setup from its seed: the convention
    the port's `setup_device` states (two SHA-256 rounds, big-endian, mod r)."""
    h = hashlib.sha256(f"zkpoa-srs|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R


def dev_trapdoors(seed: str) -> Dict[str, int]:
    return {k: dev_trapdoor(seed, k) for k in ("tau", "alpha", "beta", "gamma", "delta")}


@dataclass
class Statement:
    """A rank-1 constraint system as plain arrays: for each of 'a', 'b',
    'c' the (constraint, wire, coefficient id) of every entry, and the
    coefficients by id. Wire 0 is the constant 1, wires 1..n_public the
    public values."""

    entries: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    pool: List[int]
    n_constraints: int
    n_wires: int
    n_public: int

    @property
    def domain(self) -> int:
        m = 1
        while m < max(self.n_constraints, 2):
            m <<= 1
        return m


@dataclass
class QapAtTau:
    """A witness's QAP values at tau, whole and over wires 0..n_public."""

    a: int
    b: int
    c: int
    a_pub: int
    b_pub: int
    c_pub: int


def qap_at_tau(stmt: Statement, witnesses: Sequence[Sequence[int]], tau: int,
               device) -> List[QapAtTau]:
    """A(tau), B(tau), C(tau) and their public parts for each witness:
    sum over entries e of coeff_e * w[wire_e] * L_row_e(tau)."""
    lag = fr.lagrange_at(tau, stmt.domain, device)
    pool = fr.to_limbs([v % R for v in stmt.pool], device)
    w_mont = [fr.mont_of(fr.to_limbs([int(x) % R for x in w], device)) for w in witnesses]
    sums = [{} for _ in witnesses]
    for mat in ("a", "b", "c"):
        row, wire, cid = stmt.entries[mat]
        tot = [[0, 0] for _ in witnesses]
        for off in range(0, len(row), ENTRY_CHUNK):
            sl = slice(off, off + ENTRY_CHUNK)
            r_i = torch.from_numpy(row[sl]).to(device)
            w_i = torch.from_numpy(wire[sl]).to(device)
            c_i = torch.from_numpy(cid[sl]).to(device)
            coeff_lag = fr.mont_mul(pool[c_i], lag[r_i])  # plain coeff * L
            public = w_i <= stmt.n_public
            for k, wm in enumerate(w_mont):
                prod = fr.mont_mul(coeff_lag, wm[w_i])  # plain coeff * L * w
                tot[k][0] += fr.limb_sum(prod)
                tot[k][1] += fr.limb_sum(prod[public])
        for k in range(len(witnesses)):
            sums[k][mat] = tot[k][0] % R
            sums[k][mat + "_pub"] = tot[k][1] % R
    return [QapAtTau(**s) for s in sums]


def proof_scalars(q: QapAtTau, td: Dict[str, int], r: int, s: int) -> Tuple[int, int, int]:
    alpha, beta, delta = td["alpha"], td["beta"], td["delta"]
    a = (alpha + q.a + r * delta) % R
    b = (beta + q.b + s * delta) % R
    k = beta * (q.a - q.a_pub) + alpha * (q.b - q.b_pub) + (q.c - q.c_pub)
    c = ((k + q.a * q.b - q.c) * pow(delta, -1, R) + s * a + r * b - r * s * delta) % R
    return a, b, c


def proof_points(scalars: Tuple[int, int, int]):
    a, b, c = scalars
    return (bn254.g1_mul(bn254.G1_GEN, a), bn254.g2_mul(bn254.G2_GEN, b),
            bn254.g1_mul(bn254.G1_GEN, c))


# -- a plain verifier of snarkjs JSON (recorded proofs) ---------------------


def _g1(coords):
    x, y, z = (int(c) for c in coords)
    if z == 0:
        return None
    zi = pow(z, -1, bn254.P)
    return (x * zi % bn254.P, y * zi % bn254.P)


def _g2(coords):
    (x0, x1), (y0, y1), (z0, z1) = ((int(c[0]), int(c[1])) for c in coords)
    if (z0, z1) == (0, 0):
        return None
    zi = bn254.fp2_inv((z0, z1))
    return (bn254.fp2_mul((x0, x1), zi), bn254.fp2_mul((y0, y1), zi))


def verify(vk: dict, proof: dict, publics: Sequence[int]) -> bool:
    """e(A, B) = e(alpha, beta) e(IC(publics), gamma) e(C, delta)."""
    pa, pb, pc = _g1(proof["pi_a"]), _g2(proof["pi_b"]), _g1(proof["pi_c"])
    ic = [_g1(p) for p in vk["IC"]]
    if len(publics) != len(ic) - 1:
        return False
    g1s = [pa, pc, _g1(vk["vk_alpha_1"]), *ic]
    g2s = [pb, *(_g2(vk[k]) for k in ("vk_beta_2", "vk_gamma_2", "vk_delta_2"))]
    if not all(bn254.g1_is_on_curve(p) for p in g1s) or \
            not all(bn254.g2_is_on_curve(p) for p in g2s):
        return False
    acc = ic[0]
    for v, pt in zip(publics, ic[1:]):
        acc = bn254.g1_add(acc, bn254.g1_mul(pt, int(v) % R))
    return bn254.multi_pairing_check([
        (bn254.g1_neg(pa), pb),
        (_g1(vk["vk_alpha_1"]), _g2(vk["vk_beta_2"])),
        (acc, _g2(vk["vk_gamma_2"])),
        (pc, _g2(vk["vk_delta_2"])),
    ])
