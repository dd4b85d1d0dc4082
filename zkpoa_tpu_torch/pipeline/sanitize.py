# Copy of zkpoa_tpu/pipeline/sanitize.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Groth16 proof/vkey "sanitization" for recursion: re-encode a snarkjs
proof + verification key into the register format the in-snark verifier
(circom-pairing style) consumes as private signals.

Framework equivalent of reference scripts/sanitize_groth16_proof.py:39-162:
  * all curve points projective -> affine,
  * pa negated (the verifier checks e(-A,B)·e(alpha,beta)·e(vk_x,gamma)
    ·e(C,delta) == 1),
  * e(-alpha, beta) PRE-computed outside the snark — here with our own
    BN254 pairing (the reference shells out to py_ecc),
  * every field element split into 6 x 43-bit registers
    (sanitize_groth16_proof.py:113-114), Fp2 as [c0, c1], Fp12 as six
    w^i coefficients over Fp2 (circom-pairing's Fp12 = Fp2[w]/(w^6 - (9+u))
    basis, which matches our tower with w^2 = v, v^3 = 9+u).

Output JSON shape = Groth16ProofAsInput (scripts/lib/interfaces.ts:38-47):
gamma2, delta2, negalfa1xbeta2, IC, negpa, pb, pc, pubInput.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

from ..fields import bn254
from ..prover.groth16 import Proof, VerifyingKey
from ..utils.serde import to_limbs

N_BITS = 43
K_REGS = 6


def _fp(x: int) -> List[int]:
    return to_limbs(x % bn254.P, N_BITS, K_REGS)


def _fp2(x) -> List[List[int]]:
    return [_fp(x[0]), _fp(x[1])]


def _g1(pt) -> List[List[int]]:
    if pt is None:
        raise ValueError("infinity G1 point cannot be sanitized")
    return [_fp(pt[0]), _fp(pt[1])]


def _g2(pt) -> List[List[List[int]]]:
    if pt is None:
        raise ValueError("infinity G2 point cannot be sanitized")
    return [_fp2(pt[0]), _fp2(pt[1])]


def _fp12(e) -> List[List[List[int]]]:
    """Tower Fp12 ((c0,c2,c4),(c1,c3,c5)) -> [w^0..w^5] coefficients, each
    an Fp2 as [c0 regs, c1 regs]."""
    (c0, c2, c4), (c1, c3, c5) = e
    coeffs = [c0, c1, c2, c3, c4, c5]
    return [_fp2(c) for c in coeffs]


def sanitize(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> Dict[str, Any]:
    neg_alpha = bn254.g1_neg(vk.alpha_1)
    neg_alfa1xbeta2 = bn254.pairing(vk.beta_2, neg_alpha)
    return {
        "gamma2": _g2(vk.gamma_2),
        "delta2": _g2(vk.delta_2),
        "negalfa1xbeta2": _fp12(neg_alfa1xbeta2),
        "IC": [_g1(p) for p in vk.ic],
        "negpa": _g1(bn254.g1_neg(proof.pi_a)),
        "pb": _g2(proof.pi_b),
        "pc": _g1(proof.pi_c),
        "pubInput": [int(x) for x in public_inputs],
    }


def sanitize_files(vkey_path: str, proof_path: str, public_path: str, out_path: str) -> Dict[str, Any]:
    with open(vkey_path) as f:
        vk = VerifyingKey.from_json(json.load(f))
    with open(proof_path) as f:
        proof = Proof.from_json(json.load(f))
    with open(public_path) as f:
        publics = [int(x) for x in json.load(f)]
    out = sanitize(vk, proof, publics)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out
