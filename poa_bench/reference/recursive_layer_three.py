"""Public values of the recursive LayerThree(k) from its seeds (upstream
circuits/layer_three.circom): the 12 registers of the Pedersen commitment
g^sum h^blind on the twisted Edwards form of Curve25519 (a = -1 over
p = 2^255 - 19), then the Poseidon Merkle root of the anonymity set.
`sum` is the batches' balance sums added, each worked out as
`recursive_layer_two.expected_publics` works it out; the root is that
module's `merkle_root` over one anonymity set that holds every batch's
addresses.

The commitment is first computed as a point by plain affine
double-and-add, with d = -121665 / 121666 from its definition and the
generators as upstream writes them. The registers are then worked out by
the statement's own sequence of formulas and must normalise to that point,
or `expected_publics` raises.

Where this follows the port's algorithm and not upstream's, and why.
Extended coordinates (X, Y, Z, T) are not unique: each algorithm that
computes a point gives its own representative, and the judge holds the
public values element by element. Upstream's circuit takes g and h as
inputs and runs ed25519-circom's ScalarMul and PointAdd, whose registers
are those templates'; upstream's own checker compares points, not
registers (scripts/pedersen_commitment_checker.ts). The port bakes g and
h into the circuit as constants (`models/gadgets/edwards.py`), so the
registers here follow its sequence:

- each scalar's 255 bits in 8-bit windows, little-endian (31 of 8 bits,
  one of 7); window j's table entry e is e 2^(8j) B in affine-extended
  form (x, y, 1, x y), the identity (0, 1, 1, 0);
- the accumulator starts as window 0's entry itself, and each further
  window adds its entry by the complete mixed addition with the operands
  (y - x, y + x, 2 d x y): A = (Y - X)(y - x), B = (Y + X)(y + x),
  C = T 2 d x y, D = 2 Z, then E = B - A, F = D - C, G = D + C, H = B + A
  and (E F, G H, F G, E H);
- g's sum and h's sum meet in one complete extended addition (RFC 8032
  with C = 2 d T1 T2 and D = 2 Z1 Z2), each output coordinate canonical
  (below p);
- each coordinate as 3 x 85-bit little-endian registers, in the order
  X, Y, Z, T (upstream's layout, scripts/lib/pedersen_commitment.ts).

Every intermediate is taken mod p: the circuit's foreign-field products
reduce their results, so only the canonical outputs are public.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from .. import fixtures
from .bn254 import R
from .recursive_layer_two import merkle_root

P = 2**255 - 19
D = -121665 * pow(121666, -1, P) % P
SCALAR_BITS = 255
WINDOW = 8
LIMB_BITS, N_LIMBS = 85, 3

# upstream scripts/lib/pedersen_commitment.ts: g is the ed25519 base point,
# h the second generator that Bulletproofs and DAPOL derive (Ristretto
# compatible), both in extended coordinates (X, Y, Z, T)
G_EXT = (
    15112221349535400772501151409588531511454012693041857206046113283949847762202,
    46316835694926478169428394003475163141307993866256225615783033603165251855960,
    1,
    46827403850823179245072216630277197565144205554125654976674165829533817101731,
)
H_EXT = (
    33610936965734216034622052748864527785054979741013463956582067314415336407764,
    39037926758455103342491841394431773648115673280860795116462000885017926418697,
    44972472311651602601636560056538958210842501314939311016992875096561375476462,
    25285931357802837959040485138497351343220742265312934020814563180777586254493,
)

Affine = Tuple[int, int]
IDENTITY: Affine = (0, 1)


def affine(ext) -> Affine:
    x, y, z, t = ext
    zi = pow(z, -1, P)
    ax, ay = x * zi % P, y * zi % P
    if t * zi % P != ax * ay % P or not on_curve((ax, ay)):
        raise ValueError("not a point of the curve in extended coordinates")
    return ax, ay


def on_curve(pt: Affine) -> bool:
    x, y = pt
    return (-x * x + y * y - 1 - D * x * x * y * y) % P == 0


def add(p1: Affine, p2: Affine) -> Affine:
    """The affine twisted Edwards addition law, a = -1."""
    (x1, y1), (x2, y2) = p1, p2
    k = D * x1 * x2 * y1 * y2 % P
    return ((x1 * y2 + y1 * x2) * pow(1 + k, -1, P) % P,
            (y1 * y2 + x1 * x2) * pow(1 - k, -1, P) % P)


def mul(pt: Affine, k: int) -> Affine:
    acc = IDENTITY
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def commitment(total: int, blind: int) -> Affine:
    return add(mul(affine(G_EXT), total), mul(affine(H_EXT), blind))


def _fixed_base(base: Affine, k: int):
    """k B by the statement's windows, as an extended point mod p."""
    acc, shifted = None, base
    for start in range(0, SCALAR_BITS, WINDOW):
        w = min(WINDOW, SCALAR_BITS - start)
        x, y = mul(shifted, (k >> start) & ((1 << w) - 1))
        for _ in range(w):
            shifted = add(shifted, shifted)
        if acc is None:
            acc = (x, y, 1, x * y % P)
            continue
        X, Y, Z, T = acc
        a = (Y - X) * (y - x)
        b = (Y + X) * (y + x)
        c = T * 2 * D * x * y
        d = 2 * Z
        e, f, g, h = b - a, d - c, d + c, b + a
        acc = (e * f % P, g * h % P, f * g % P, e * h % P)
    return acc


def _ext_add(p1, p2):
    (x1, y1, z1, t1), (x2, y2, z2, t2) = p1, p2
    a = (y1 - x1) * (y2 - x2)
    b = (y1 + x1) * (y2 + x2)
    c = t1 * t2 * 2 * D
    d = 2 * z1 * z2
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def registers(total: int, blind: int) -> List[int]:
    """The 12 public registers of g^total h^blind, checked against the
    double-and-add point."""
    if not (0 <= total < R and 0 <= blind < 1 << SCALAR_BITS):
        raise ValueError("the total is a BN254 scalar and the blinding factor 255-bit")
    ext = _ext_add(_fixed_base(affine(G_EXT), total), _fixed_base(affine(H_EXT), blind))
    mask = (1 << LIMB_BITS) - 1
    regs = [(v >> (LIMB_BITS * i)) & mask for v in ext for i in range(N_LIMBS)]
    check_registers(regs, commitment(total, blind))
    return regs


def check_registers(regs: List[int], point: Affine) -> None:
    """Raises unless the 12 registers are an extended point (X, Y, Z, T),
    each coordinate below p in 3 x 85-bit limbs, and that point is
    `point`: X / Z = x, Y / Z = y and T Z = X Y."""
    if len(regs) != 4 * N_LIMBS or not all(0 <= r < 1 << LIMB_BITS for r in regs):
        raise ValueError("not 12 registers of 85 bits")
    ext = [sum(regs[N_LIMBS * c + i] << (LIMB_BITS * i) for i in range(N_LIMBS))
           for c in range(4)]
    if not all(v < P for v in ext) or ext[2] == 0 or affine(ext) != point:
        raise ValueError("the commitment's registers are not the point g^sum h^blind")


def blinding_factor(seed: str) -> int:
    """A 255-bit blinding factor from a seed."""
    h = hashlib.sha256(f"poa_bench|blind|{seed}".encode()).digest()
    return int.from_bytes(h, "big") >> 1


def expected_publics(raw: dict) -> List[int]:
    n = raw["n_sigs"]
    entries = [e for s in raw["sig_seeds"] for e in fixtures.signatures(n, s)]
    rows = fixtures.anon_set(entries, raw["anon_size"], raw["anon_seed"])
    total = sum(k % 1000 for s in raw["sig_seeds"] for k in fixtures.private_keys(n, s))
    return registers(total, blinding_factor(raw["blind_seed"])) + \
        [merkle_root(rows, raw["height"])]
