# Copy of zkpoa_tpu/prover/groth16.py; only its imports, and the reference repository's paths in its text, are rewritten.
"""Groth16 over BN254: host-side verification (snarkjs-compatible JSON), and
— as later stages of this module — trusted setup and the TPU proving path.

The verifier is the framework's independent referee, the role snarkjs's
`groth16 verify` plays in the reference (scripts/g16_verify.sh:212-216). It
consumes exactly the JSON shapes snarkjs emits (vkey with projective
3-coordinate points as decimal strings, proof with pi_a/pi_b/pi_c), so the
reference's golden artifacts in reference tests/** are directly
checkable — that is the bit-exactness contract of SURVEY.md §7.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from ..fields import bn254


# ---------------------------------------------------------------------------
# snarkjs JSON parsing
# ---------------------------------------------------------------------------


def _g1_from_json(coords: Sequence[Any]):
    """snarkjs G1 points are projective [x, y, z] decimal strings (z in {0,1}
    in practice; general z handled by normalizing)."""
    x, y, z = (int(c) for c in coords)
    if z == 0:
        return None
    if z != 1:
        z_inv = bn254.fp_inv(z)
        x, y = x * z_inv % bn254.P, y * z_inv % bn254.P
    return (x % bn254.P, y % bn254.P)


def _g2_from_json(coords: Sequence[Any]):
    (x0, x1), (y0, y1), (z0, z1) = (
        (int(c[0]), int(c[1])) for c in coords
    )
    z = (z0 % bn254.P, z1 % bn254.P)
    if z == bn254.FP2_ZERO:
        return None
    x = (x0 % bn254.P, x1 % bn254.P)
    y = (y0 % bn254.P, y1 % bn254.P)
    if z != bn254.FP2_ONE:
        z_inv = bn254.fp2_inv(z)
        x, y = bn254.fp2_mul(x, z_inv), bn254.fp2_mul(y, z_inv)
    return (x, y)


def _g1_to_json(pt) -> List[str]:
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def _g2_to_json(pt) -> List[List[str]]:
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = pt[0], pt[1]
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


class VerifyingKey:
    """Parsed snarkjs verification key."""

    def __init__(self, alpha_1, beta_2, gamma_2, delta_2, ic, n_public: int):
        self.alpha_1 = alpha_1
        self.beta_2 = beta_2
        self.gamma_2 = gamma_2
        self.delta_2 = delta_2
        self.ic = ic
        self.n_public = n_public

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "VerifyingKey":
        assert d.get("protocol", "groth16") == "groth16"
        assert d.get("curve", "bn128") in ("bn128", "bn254")
        return cls(
            alpha_1=_g1_from_json(d["vk_alpha_1"]),
            beta_2=_g2_from_json(d["vk_beta_2"]),
            gamma_2=_g2_from_json(d["vk_gamma_2"]),
            delta_2=_g2_from_json(d["vk_delta_2"]),
            ic=[_g1_from_json(p) for p in d["IC"]],
            n_public=int(d["nPublic"]),
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "protocol": "groth16",
            "curve": "bn128",
            "nPublic": self.n_public,
            "vk_alpha_1": _g1_to_json(self.alpha_1),
            "vk_beta_2": _g2_to_json(self.beta_2),
            "vk_gamma_2": _g2_to_json(self.gamma_2),
            "vk_delta_2": _g2_to_json(self.delta_2),
            "IC": [_g1_to_json(p) for p in self.ic],
        }


class Proof:
    def __init__(self, pi_a, pi_b, pi_c):
        self.pi_a = pi_a
        self.pi_b = pi_b
        self.pi_c = pi_c

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Proof":
        return cls(
            pi_a=_g1_from_json(d["pi_a"]),
            pi_b=_g2_from_json(d["pi_b"]),
            pi_c=_g1_from_json(d["pi_c"]),
        )

    def to_json(self) -> Dict[str, Any]:
        return {
            "pi_a": _g1_to_json(self.pi_a),
            "pi_b": _g2_to_json(self.pi_b),
            "pi_c": _g1_to_json(self.pi_c),
            "protocol": "groth16",
            "curve": "bn128",
        }


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def compute_vk_x(vk: VerifyingKey, public_inputs: Sequence[int]):
    """IC[0] + sum_i pub_i * IC[i+1]."""
    if len(public_inputs) != len(vk.ic) - 1:
        raise ValueError(
            f"expected {len(vk.ic) - 1} public inputs, got {len(public_inputs)}"
        )
    acc = vk.ic[0]
    for value, point in zip(public_inputs, vk.ic[1:]):
        acc = bn254.g1_add(acc, bn254.g1_mul(point, int(value) % bn254.R))
    return acc


def verify(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    """Check e(A,B) == e(alpha,beta) * e(vk_x,gamma) * e(C,delta).

    Implemented as prod of 4 Miller loops with one shared final exp:
    e(-A,B) * e(alpha,beta) * e(vk_x,gamma) * e(C,delta) == 1.
    """
    for g1pt in (proof.pi_a, proof.pi_c, vk.alpha_1, *vk.ic):
        if not bn254.g1_is_on_curve(g1pt):
            return False
    for g2pt in (proof.pi_b, vk.beta_2, vk.gamma_2, vk.delta_2):
        if not bn254.g2_is_on_curve(g2pt):
            return False
    vk_x = compute_vk_x(vk, public_inputs)
    return bn254.multi_pairing_check(
        [
            (bn254.g1_neg(proof.pi_a), proof.pi_b),
            (vk.alpha_1, vk.beta_2),
            (vk_x, vk.gamma_2),
            (proof.pi_c, vk.delta_2),
        ]
    )


def verify_files(vkey_path: str, proof_path: str, public_path: str) -> bool:
    import json

    with open(vkey_path) as f:
        vk = VerifyingKey.from_json(json.load(f))
    with open(proof_path) as f:
        proof = Proof.from_json(json.load(f))
    with open(public_path) as f:
        publics = [int(x) for x in json.load(f)]
    return verify(vk, proof, publics)
