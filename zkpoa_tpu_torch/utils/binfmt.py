# Copy of zkpoa_tpu/utils/binfmt.py; only its imports are rewritten.
"""iden3 binary container formats: .r1cs, .wtns, .zkey (Groth16/BN254).

The reference pipeline moves all heavy artifacts through these formats:
circom emits `.r1cs` (ref: scripts/g16_setup.sh:221-226), witness generators
emit `.wtns` (ref: scripts/g16_prove.sh:229-239), and snarkjs/rapidsnark
exchange proving keys as `.zkey` (ref: scripts/g16_setup.sh:240-253,
scripts/g16_prove.sh:246-252). This module implements the container layout
from scratch so the TPU stack can (a) ingest circom-compiled constraint
systems and circom-generated witnesses and prove them on TPU without the
reference's C++ witgen/rapidsnark, and (b) export its own R1CS/witness/keys
for independent cross-checking by snarkjs, the role snarkjs plays as
external referee in the reference (scripts/g16_verify.sh:190-216).

Container layout (all integers little-endian):
    magic[4] | u32 version | u32 nSections | { u32 type, u64 size, payload }*

Field elements are fixed-width little-endian; `.zkey` curve points are
stored in Montgomery form (x·2^256 mod q), matching snarkjs' toRprLEM
convention. Infinity is all-zero bytes.

Section 9 (H points) — BOTH conventions are supported, selected by the
ProvingKey's `h_basis` (prover/setup.py):
  * 'monomial' (our native default): (tau^i · Z(tau)/delta)·G1, which the
    NTT quotient path consumes directly (zkpoa_tpu/prover/prove.py);
  * 'coset' (snarkjs/rapidsnark convention): coset-Lagrange points
    L_i^{coset}(tau)·Z(tau)/((g^n−1)·delta)·G1 with g = w_{2n}, the
    primitive 2n-th root of unity (snarkjs builds section 9 from the odd
    Lagrange points of the 2n ptau domain; g^n = -1 so the Z constant is
    -2) — the prover then MSMs coset evaluations of A·B−C against them
    exactly as rapidsnark does (ops/ntt.py coset_qap_evals).
The container itself carries no basis marker (neither does snarkjs'), so
read_zkey takes the convention as a parameter — pass h_basis='coset' when
ingesting a foreign snarkjs-generated zkey — or h_basis='auto' to detect
it: natively-written monomial files end section 9 with an infinity pad
point, coset files carry exactly domainSize finite points.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Optional, Sequence, Tuple

from ..fields import bn254

R1CS_MAGIC = b"r1cs"
WTNS_MAGIC = b"wtns"
ZKEY_MAGIC = b"zkey"

N8 = 32
_MONT = 1 << (8 * N8)  # 2^256


# ---------------------------------------------------------------------------
# Container plumbing
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated file")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes(8))[0]

    def fe(self, n8: int = N8) -> int:
        return int.from_bytes(self.bytes(n8), "little")


def _read_container(path: str, magic: bytes) -> Dict[int, List[bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    rd = _Reader(data)
    if rd.bytes(4) != magic:
        raise ValueError(f"{path}: bad magic (expected {magic!r})")
    rd.u32()  # version
    n_sections = rd.u32()
    sections: Dict[int, List[bytes]] = {}
    for _ in range(n_sections):
        stype = rd.u32()
        size = rd.u64()
        sections.setdefault(stype, []).append(rd.bytes(size))
    return sections


def _one(sections: Dict[int, List[bytes]], stype: int) -> bytes:
    if stype not in sections or len(sections[stype]) != 1:
        raise ValueError(f"missing/duplicate section {stype}")
    return sections[stype][0]


def _write_container(
    path: str, magic: bytes, version: int, sections: Sequence[Tuple[int, bytes]]
) -> None:
    with open(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<II", version, len(sections)))
        for stype, payload in sections:
            f.write(struct.pack("<IQ", stype, len(payload)))
            f.write(payload)


def _fe_bytes(x: int, n8: int = N8) -> bytes:
    return int(x).to_bytes(n8, "little")


# ---------------------------------------------------------------------------
# Montgomery-form point codecs (zkey convention)
# ---------------------------------------------------------------------------


def _to_mont(x: int) -> bytes:
    return ((x % bn254.P) * _MONT % bn254.P).to_bytes(N8, "little")


def _from_mont(b: bytes) -> int:
    return int.from_bytes(b, "little") * pow(_MONT, -1, bn254.P) % bn254.P


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\0" * (2 * N8)
    return _to_mont(pt[0]) + _to_mont(pt[1])


def _g1_parse(b: bytes):
    if b == b"\0" * (2 * N8):
        return None
    return (_from_mont(b[:N8]), _from_mont(b[N8:]))


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\0" * (4 * N8)
    (x0, x1), (y0, y1) = pt
    return _to_mont(x0) + _to_mont(x1) + _to_mont(y0) + _to_mont(y1)


def _g2_parse(b: bytes):
    if b == b"\0" * (4 * N8):
        return None
    vals = [_from_mont(b[i * N8 : (i + 1) * N8]) for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


# ---------------------------------------------------------------------------
# .wtns — witness vectors
# ---------------------------------------------------------------------------


def write_wtns(path: str, witness: Sequence[int], prime: int = bn254.R) -> None:
    """Witness file: section 1 = {u32 n8, prime, u32 count}, section 2 = values."""
    header = struct.pack("<I", N8) + _fe_bytes(prime) + struct.pack("<I", len(witness))
    body = b"".join(_fe_bytes(int(w) % prime) for w in witness)
    _write_container(path, WTNS_MAGIC, 2, [(1, header), (2, body)])


def read_wtns(path: str) -> List[int]:
    sections = _read_container(path, WTNS_MAGIC)
    rd = _Reader(_one(sections, 1))
    n8 = rd.u32()
    rd.fe(n8)  # prime (not needed; values are canonical residues)
    count = rd.u32()
    body = _Reader(_one(sections, 2))
    return [body.fe(n8) for _ in range(count)]


# ---------------------------------------------------------------------------
# .r1cs — constraint systems
# ---------------------------------------------------------------------------


def _rows_to_per_constraint(
    rows: Sequence[Tuple[int, int, int]], n: int
) -> List[List[Tuple[int, int]]]:
    per: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for i, wire, coeff in rows:
        per[i].append((wire, coeff % bn254.R))
    return per


def write_r1cs(path: str, r1cs, n_pub_out: Optional[int] = None) -> None:
    """Emit an .r1cs for our frozen constraint system (models/r1cs.py R1CS).

    Wire order already matches circom's: 0 = one, then public, then private.
    We record all publics as outputs (the frontend doesn't distinguish
    outputs from public inputs; verification semantics are identical).
    Sections: 1 = header, 2 = constraints (A,B,C term lists), 3 = wire→label.
    """
    if n_pub_out is None:
        n_pub_out = r1cs.n_public
    n_pub_in = r1cs.n_public - n_pub_out
    n_prv = r1cs.n_wires - 1 - r1cs.n_public
    header = (
        struct.pack("<I", N8)
        + _fe_bytes(bn254.R)
        + struct.pack(
            "<IIIIQI",
            r1cs.n_wires,
            n_pub_out,
            n_pub_in,
            n_prv,
            r1cs.n_wires,  # nLabels: 1:1, no label compaction
            r1cs.n_constraints,
        )
    )
    pa = _rows_to_per_constraint(r1cs.a_rows, r1cs.n_constraints)
    pb = _rows_to_per_constraint(r1cs.b_rows, r1cs.n_constraints)
    pc = _rows_to_per_constraint(r1cs.c_rows, r1cs.n_constraints)
    chunks: List[bytes] = []
    for i in range(r1cs.n_constraints):
        for terms in (pa[i], pb[i], pc[i]):
            chunks.append(struct.pack("<I", len(terms)))
            for wire, coeff in terms:
                chunks.append(struct.pack("<I", wire) + _fe_bytes(coeff))
    wire2label = b"".join(struct.pack("<Q", i) for i in range(r1cs.n_wires))
    _write_container(
        path, R1CS_MAGIC, 1, [(1, header), (2, b"".join(chunks)), (3, wire2label)]
    )


def read_r1cs(path: str):
    """Parse an .r1cs (ours or circom-emitted) into models/r1cs.py R1CS."""
    from ..models.r1cs import R1CS

    sections = _read_container(path, R1CS_MAGIC)
    rd = _Reader(_one(sections, 1))
    n8 = rd.u32()
    prime = rd.fe(n8)
    if prime != bn254.R:
        raise ValueError("r1cs prime is not BN254 Fr")
    n_wires = rd.u32()
    n_pub_out = rd.u32()
    n_pub_in = rd.u32()
    rd.u32()  # nPrvIn (redundant)
    rd.u64()  # nLabels
    n_constraints = rd.u32()

    body = _Reader(_one(sections, 2))
    a_rows: List[Tuple[int, int, int]] = []
    b_rows: List[Tuple[int, int, int]] = []
    c_rows: List[Tuple[int, int, int]] = []
    for i in range(n_constraints):
        for rows in (a_rows, b_rows, c_rows):
            n_terms = body.u32()
            for _ in range(n_terms):
                wire = body.u32()
                coeff = body.fe(n8)
                rows.append((i, wire, coeff))
    return R1CS(
        n_wires=n_wires,
        n_public=n_pub_out + n_pub_in,
        a_rows=a_rows,
        b_rows=b_rows,
        c_rows=c_rows,
        n_constraints=n_constraints,
    )


# ---------------------------------------------------------------------------
# .zkey — Groth16 proving keys
# ---------------------------------------------------------------------------

_GROTH16_PROTOCOL_ID = 1


def write_zkey(path: str, pk, r1cs) -> None:
    """Serialize a ProvingKey (prover/setup.py) to the 10-section zkey layout.

    Matrix coefficients (section 4) are re-derived from the R1CS exactly as
    the reference toolchain derives them from the circom output: every A and
    B term, with B terms of public wires also folded into A per snarkjs'
    public-input handling — we store raw A/B terms (m=0/1) which is what our
    reader consumes; C terms are implied by A·B−C=0 and not stored (snarkjs
    likewise stores only m∈{0,1}).
    """
    from ..prover.groth16 import VerifyingKey

    vk = VerifyingKey.from_json(pk.vk_json)
    header2 = (
        struct.pack("<I", N8)
        + _fe_bytes(bn254.P)
        + struct.pack("<I", N8)
        + _fe_bytes(bn254.R)
        + struct.pack("<III", pk.n_vars, pk.n_public, pk.domain_size)
        + _g1_bytes(pk.alpha1)
        + _g1_bytes(pk.beta1)
        + _g2_bytes(pk.beta2)
        + _g2_bytes(vk.gamma_2)
        + _g1_bytes(pk.delta1)
        + _g2_bytes(pk.delta2)
    )
    ic = b"".join(_g1_bytes(p) for p in vk.ic)

    coeff_chunks: List[bytes] = []
    n_coeffs = 0
    for matrix, rows in ((0, r1cs.a_rows), (1, r1cs.b_rows)):
        for i, wire, coeff in rows:
            coeff_chunks.append(
                struct.pack("<III", matrix, i, wire)
                + ((coeff % bn254.R) * _MONT % bn254.R).to_bytes(N8, "little")
            )
            n_coeffs += 1
    coeffs = struct.pack("<I", n_coeffs) + b"".join(coeff_chunks)

    pts_a = b"".join(_g1_bytes(p) for p in pk.a_query)
    pts_b1 = b"".join(_g1_bytes(p) for p in pk.b1_query)
    pts_b2 = b"".join(_g2_bytes(p) for p in pk.b2_query)
    pts_c = b"".join(_g1_bytes(p) for p in pk.c_query)
    # monomial basis holds domainSize-1 points: pad to domainSize with
    # infinity; coset basis is exactly domainSize (module docstring)
    h_pts = list(pk.h_query) + [None] * (pk.domain_size - len(pk.h_query))
    pts_h = b"".join(_g1_bytes(p) for p in h_pts)
    contributions = b"\0" * 64 + struct.pack("<I", 0)

    _write_container(
        path,
        ZKEY_MAGIC,
        1,
        [
            (1, struct.pack("<I", _GROTH16_PROTOCOL_ID)),
            (2, header2),
            (3, ic),
            (4, coeffs),
            (5, pts_a),
            (6, pts_b1),
            (7, pts_b2),
            (8, pts_c),
            (9, pts_h),
            (10, contributions),
        ],
    )


def read_zkey(path: str, h_basis: str = "monomial"):
    """Parse a .zkey into (ProvingKey, coeffs) where coeffs is the section-4
    list of (matrix, constraint, signal, value) with canonical Fr values.

    h_basis selects the section-9 convention (module docstring): 'monomial'
    for zkeys we wrote natively, 'coset' for snarkjs/rapidsnark zkeys."""
    from ..prover.groth16 import VerifyingKey
    from ..prover.setup import ProvingKey

    sections = _read_container(path, ZKEY_MAGIC)
    if struct.unpack("<I", _one(sections, 1))[0] != _GROTH16_PROTOCOL_ID:
        raise ValueError("not a Groth16 zkey")
    rd = _Reader(_one(sections, 2))
    n8q = rd.u32()
    if rd.fe(n8q) != bn254.P:
        raise ValueError("zkey base field is not BN254 Fq")
    n8r = rd.u32()
    if rd.fe(n8r) != bn254.R:
        raise ValueError("zkey scalar field is not BN254 Fr")
    n_vars = rd.u32()
    n_public = rd.u32()
    domain_size = rd.u32()
    alpha1 = _g1_parse(rd.bytes(2 * N8))
    beta1 = _g1_parse(rd.bytes(2 * N8))
    beta2 = _g2_parse(rd.bytes(4 * N8))
    gamma2 = _g2_parse(rd.bytes(4 * N8))
    delta1 = _g1_parse(rd.bytes(2 * N8))
    delta2 = _g2_parse(rd.bytes(4 * N8))

    ic_raw = _one(sections, 3)
    ic = [
        _g1_parse(ic_raw[i * 2 * N8 : (i + 1) * 2 * N8])
        for i in range(len(ic_raw) // (2 * N8))
    ]

    crd = _Reader(_one(sections, 4))
    n_coeffs = crd.u32()
    mont_inv = pow(_MONT, -1, bn254.R)
    coeffs = []
    for _ in range(n_coeffs):
        m = crd.u32()
        c = crd.u32()
        s = crd.u32()
        v = int.from_bytes(crd.bytes(N8), "little") * mont_inv % bn254.R
        coeffs.append((m, c, s, v))

    def g1_list(raw: bytes) -> List:
        return [
            _g1_parse(raw[i * 2 * N8 : (i + 1) * 2 * N8])
            for i in range(len(raw) // (2 * N8))
        ]

    def g2_list(raw: bytes) -> List:
        return [
            _g2_parse(raw[i * 4 * N8 : (i + 1) * 4 * N8])
            for i in range(len(raw) // (4 * N8))
        ]

    a_query = g1_list(_one(sections, 5))
    b1_query = g1_list(_one(sections, 6))
    b2_query = g2_list(_one(sections, 7))
    c_query = g1_list(_one(sections, 8))
    h_query = g1_list(_one(sections, 9))
    if h_basis == "auto":
        # natively written monomial zkeys pad section 9 to domainSize with
        # an infinity tail point; snarkjs coset zkeys have all points finite
        h_basis = "monomial" if (h_query and h_query[-1] is None) else "coset"
    if h_basis == "monomial":
        # drop the infinity padding we write at the tail of section 9
        while h_query and h_query[-1] is None:
            h_query.pop()
    elif h_basis == "coset":
        if any(p is None for p in h_query):
            raise ValueError(
                "h_basis='coset' but section 9 contains infinity points — "
                "this looks like a natively written monomial zkey"
            )

    vk = VerifyingKey(alpha1, beta2, gamma2, delta2, ic, n_public)
    pk = ProvingKey(
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        a_query=a_query,
        b1_query=b1_query,
        c_query=c_query,
        h_query=h_query,
        alpha1=alpha1,
        beta1=beta1,
        delta1=delta1,
        b2_query=b2_query,
        beta2=beta2,
        delta2=delta2,
        vk_json=vk.to_json(),
        h_basis=h_basis,
    )
    return pk, coeffs


def r1cs_from_zkey_coeffs(
    coeffs: Sequence[Tuple[int, int, int, int]],
    n_vars: int,
    n_public: int,
    n_constraints: Optional[int] = None,
):
    """Reconstruct A/B rows from zkey section 4 (C rows are not stored in a
    zkey; proving only needs A, B, and the precomputed point tables)."""
    from ..models.r1cs import R1CS

    a_rows = [(c, s, v) for m, c, s, v in coeffs if m == 0]
    b_rows = [(c, s, v) for m, c, s, v in coeffs if m == 1]
    if n_constraints is None:
        n_constraints = 1 + max((c for _, c, _, _ in coeffs), default=-1)
    return R1CS(
        n_wires=n_vars,
        n_public=n_public,
        a_rows=a_rows,
        b_rows=b_rows,
        c_rows=[],
        n_constraints=n_constraints,
    )
