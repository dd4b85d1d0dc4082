"""Carry a proving key made by the JAX package over to the port.

`proving_key_from_jax(pk, device)` turns a `zkpoa_tpu.prover.setup.ProvingKey`
into the port's `ProvingKey`. Device tables (`DeviceG1Points` /
`DeviceG2Points`, 16 x 16-bit Montgomery limbs) are fetched with
`np.asarray` and re-cut into 8 x 32-bit limbs: both packages use
R = 2^256, so the Montgomery integers are unchanged. Host-list tables
(affine int tuples) are encoded afresh. This module touches JAX arrays only
through numpy and imports nothing of JAX itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.curve import BN254_G1, DeviceG1Points
from .ops.fp2 import BN254_G2, DeviceG2Points
from .prover.setup import ProvingKey


def limbs16_to_32(a) -> np.ndarray:
    """[..., 16] 16-bit limbs (uint32 array) -> [..., 8] int32 limbs."""
    a = np.asarray(a).astype(np.uint32)
    return (a[..., 0::2] | (a[..., 1::2] << 16)).astype(np.uint32).view(np.int32)


def _g1_table(q, device) -> DeviceG1Points:
    if isinstance(q, list):
        return DeviceG1Points(*BN254_G1.encode_affine(q, device))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(limbs16_to_32(a))).to(device)  # noqa: E731
    return DeviceG1Points(t(q.xs), t(q.ys), torch.from_numpy(np.asarray(q.valid).copy()).to(device))


def _g2_table(q, device) -> DeviceG2Points:
    if isinstance(q, list):
        return DeviceG2Points(*BN254_G2.encode_affine(q, device))

    def t(pair):
        arr = np.stack([limbs16_to_32(pair[0]), limbs16_to_32(pair[1])], axis=-2)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return DeviceG2Points(t(q.xs), t(q.ys), torch.from_numpy(np.asarray(q.valid).copy()).to(device))


def proving_key_from_jax(pk, device) -> ProvingKey:
    """The port's ProvingKey holding exactly the points of the JAX key."""
    return ProvingKey(
        n_vars=pk.n_vars, n_public=pk.n_public, domain_size=pk.domain_size,
        a_query=_g1_table(pk.a_query, device), b1_query=_g1_table(pk.b1_query, device),
        c_query=_g1_table(pk.c_query, device), h_query=_g1_table(pk.h_query, device),
        alpha1=pk.alpha1, beta1=pk.beta1, delta1=pk.delta1,
        b2_query=_g2_table(pk.b2_query, device), beta2=pk.beta2, delta2=pk.delta2,
        vk_json=pk.vk_json, h_basis=getattr(pk, "h_basis", "monomial"),
    )
