# Copy of zkpoa_tpu/fields/curve25519.py; only its imports, and the reference repository's paths in its text, are rewritten.
"""Exact host-side Curve25519 (twisted Edwards form) arithmetic and the
Pedersen commitment used by layer 3.

Matches the behavior of the reference's host-side mirror
(reference scripts/lib/pedersen_commitment.ts): extended Edwards
coordinates (X, Y, Z, T) on -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255-19)
— wait, note: the reference file states the equation as
x^2 + y^2 = 1 + d x^2 y^2 with the ed25519 d constant; point arithmetic
below follows the a=-1 ed25519 addition law, which is what both
ed25519-circom and the Bulletproofs/DAPOL generators use (the generator
constants below only lie on the a=-1 curve).

The in-circuit representation chunks each coordinate into 3 x 85-bit
little-endian registers (pedersen_commitment.ts:163-177); helpers for that
layout live in zkpoa_tpu.utils.serde.

Generator constants are protocol-defining public parameters taken from the
reference (pedersen_commitment.ts:12-26): g is the standard ed25519
basepoint; h is the Bulletproofs/DAPOL derived second generator (so
commitments interoperate with DAPOL).
"""

from __future__ import annotations

from typing import Tuple

P = 2**255 - 19
# ed25519 group order (l) — scalars for Pedersen are < 2^255 but reduction
# happens only implicitly through the group structure; keep l for tests.
L = 2**252 + 27742317777372353535851937790883648493
D = 37095705934669439343138083508754565189542113879843219016388785533085940283555

# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
ExtPoint = Tuple[int, int, int, int]

GENERATOR_G: ExtPoint = (
    15112221349535400772501151409588531511454012693041857206046113283949847762202,
    46316835694926478169428394003475163141307993866256225615783033603165251855960,
    1,
    46827403850823179245072216630277197565144205554125654976674165829533817101731,
)

GENERATOR_H: ExtPoint = (
    33610936965734216034622052748864527785054979741013463956582067314415336407764,
    39037926758455103342491841394431773648115673280860795116462000885017926418697,
    44972472311651602601636560056538958210842501314939311016992875096561375476462,
    25285931357802837959040485138497351343220742265312934020814563180777586254493,
)

IDENTITY: ExtPoint = (0, 1, 1, 0)


def point_add(a: ExtPoint, b: ExtPoint) -> ExtPoint:
    """Extended-coordinates addition for a = -1 twisted Edwards (RFC 8032)."""
    x1, y1, z1, t1 = a
    x2, y2, z2, t2 = b
    A = (y1 - x1) * (y2 - x2) % P
    Bv = (y1 + x1) * (y2 + x2) % P
    C = 2 * t1 * t2 * D % P
    Dv = 2 * z1 * z2 % P
    E = (Bv - A) % P
    F = (Dv - C) % P
    Gv = (Dv + C) % P
    H = (Bv + A) % P
    return (E * F % P, Gv * H % P, F * Gv % P, E * H % P)


def point_double(a: ExtPoint) -> ExtPoint:
    return point_add(a, a)


def point_mul(pt: ExtPoint, k: int) -> ExtPoint:
    result = IDENTITY
    addend = pt
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_double(addend)
        k >>= 1
    return result


def point_neg(pt: ExtPoint) -> ExtPoint:
    x, y, z, t = pt
    return (-x % P, y, z, -t % P)


def to_affine(pt: ExtPoint) -> Tuple[int, int]:
    x, y, z, _ = pt
    z_inv = pow(z, -1, P)
    return (x * z_inv % P, y * z_inv % P)


def point_equal(a: ExtPoint, b: ExtPoint) -> bool:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1
    (pedersen_commitment.ts pointEqual semantics)."""
    x1, y1, z1, _ = a
    x2, y2, z2, _ = b
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def is_on_curve(pt: ExtPoint) -> bool:
    x, y = to_affine(pt)
    return (-x * x + y * y - 1 - D * x * x % P * y * y) % P == 0


def pedersen_commitment(secret: int, blinding_factor: int) -> ExtPoint:
    """g^secret * h^blinding (additive: secret*G + blind*H)."""
    return point_add(point_mul(GENERATOR_G, secret), point_mul(GENERATOR_H, blinding_factor))
