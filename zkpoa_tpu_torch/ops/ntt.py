"""Radix-2 NTT over the BN254 scalar field, and the Groth16 quotient h(X).

Port of `zkpoa_tpu/ops/ntt.py` (`ntt` :94, `coset_qap_evals` :145,
`quotient` :173) for both H bases. One path at every size: the JAX
package's blocked four-step variant (`ops/ntt_blocked.py`) exists to fit
TPU HBM; at a 2^21 domain the three operands here are ~200 MB.

Values are Montgomery limb tensors [n, 8]. Each butterfly stage is one
batched Montgomery product of the odd half by the stage twiddles plus a
modular add and subtract, all three through kernel B1 on the card. The
twiddles of every stage are strided slices of one table of powers of the
domain root, built on the device by a masked binary power ladder.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..fields.bn254 import FR_GENERATOR, R
from ..host import domain_root, snarkjs_coset_shift
from . import limbs as L
from .limbs import BN254_FR

_TABLES: Dict[Tuple, torch.Tensor] = {}


def pow_table(base: int, count: int, device, scale: int = 1) -> torch.Tensor:
    """[scale * base^i for i < count] as Montgomery limbs on the device:
    2 * log2(count) batched products, no sequential power chain (port of
    `prover/setup.py:279` `_dev_pow_table`)."""
    spec = BN254_FR
    bits = max((count - 1).bit_length(), 1)
    idx = torch.arange(count, device=device, dtype=torch.int64)
    t = spec.encode([scale % R], device).expand(count, 8).contiguous()
    s = spec.encode([base % R], device)
    for b in range(bits):
        bit = ((idx >> b) & 1).bool()
        t = L.select(bit, L.mont_mul(spec, t, s), t)
        if b + 1 < bits:
            s = L.mont_mul(spec, s, s)
    return t


def _cached(key, make) -> torch.Tensor:
    t = _TABLES.get(key)
    if t is None:
        t = make()
        _TABLES[key] = t
    return t


def _bitrev(log_n: int, device) -> torch.Tensor:
    i = torch.arange(1 << log_n, device=device, dtype=torch.int64)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Transform of Montgomery limbs [n, 8], n a power of two."""
    spec = BN254_FR
    n = values.shape[-2]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "size must be a power of two"
    device = values.device
    x = values[_cached(("rev", log_n, str(device)), lambda: _bitrev(log_n, device))]
    if log_n:
        w = domain_root(log_n)
        if inverse:
            w = pow(w, -1, R)
        big = _cached(("tw", log_n, inverse, str(device)),
                      lambda: pow_table(w, n // 2, device))
        for s in range(log_n):
            half = 1 << s
            tw = big[:: n // (2 * half)]  # w^(j n / 2h), j < h
            xb = x.view(n // (2 * half), 2, half, 8)
            u = xb[:, 0]
            v = L.mont_mul(spec, xb[:, 1].contiguous(), tw.contiguous())
            x = torch.stack([L.add_mod(spec, u, v), L.sub_mod(spec, u, v)], dim=1).view(n, 8)
    if inverse:
        x = L.mont_mul(spec, x, spec.encode([pow(n, -1, R)], device))
    return x


def coset_shift(values: torch.Tensor, inverse: bool = False,
                shift: int = FR_GENERATOR) -> torch.Tensor:
    """Coefficient i times shift^(+-i): evaluation domain D -> shift * D."""
    n = values.shape[-2]
    g = shift if not inverse else pow(shift, -1, R)
    tbl = _cached(("coset", n, g, str(values.device)),
                  lambda: pow_table(g, n, values.device))
    return L.mont_mul(BN254_FR, values, tbl)


def coset_qap_evals(a_ev, b_ev, c_ev, shift: int = None) -> torch.Tensor:
    """(A*B - C) evaluated over the coset shift*D: the h-MSM operand for
    keys in snarkjs' coset-Lagrange basis (port of `ntt.py:145`)."""
    if shift is None:
        shift = snarkjs_coset_shift(a_ev.shape[-2].bit_length() - 1)
    spec = BN254_FR
    a_s, b_s, c_s = (
        ntt(coset_shift(ntt(v, inverse=True), shift=shift)) for v in (a_ev, b_ev, c_ev)
    )
    return L.sub_mod(spec, L.mont_mul(spec, a_s, b_s), c_s)


def quotient(a_ev, b_ev, c_ev) -> torch.Tensor:
    """h(X) coefficients [n, 8] (Montgomery) with (A*B - C) = h * Z on the
    domain, Z = X^n - 1 (port of `ntt.py:173`)."""
    spec = BN254_FR
    n = a_ev.shape[-2]
    num = coset_qap_evals(a_ev, b_ev, c_ev, shift=FR_GENERATOR)
    zinv = pow((pow(FR_GENERATOR, n, R) - 1) % R, -1, R)
    h_s = L.mont_mul(spec, num, spec.encode([zinv], a_ev.device))
    return coset_shift(ntt(h_s, inverse=True), inverse=True)
