"""Bulk codecs between iden3 containers (.ptau, .zkey) and device tables.

The port's own companion of `utils/binfmt.py` (the copy of the JAX
package's per-point codecs, which stays the byte-level reference): whole
point sections go straight to and from `DeviceG1Points` /
`DeviceG2Points` with numpy, no Python work per point.

A container coordinate is x * 2^256 mod q, 32 bytes little endian, and the
port keeps x * R mod q as 8 little-endian 32-bit limbs with R = 2^256:
the same integer, the same bytes. So a section of N G1 points is the
array [N, 2, 8] of int32 limbs (x, y), and of N G2 points [N, 4, 8]
(x0, x1, y0, y1; an Fq2 coordinate of the port is [2, 8], c0 then c1).
Infinity is all-zero bytes: a row is valid when any limb is not zero, and
invalid rows are written as zeros.

    write_zkey_device(path, pk, r1cs)        # the 10-section Groth16 layout
    read_zkey_device(path, device, h_basis)  # -> (ProvingKey, R1CS)

give the bytes and points of `binfmt.write_zkey` / `binfmt.read_zkey`
(`zkpoa_tpu/utils/binfmt.py:278, :345`) on the decoded key; section 4's
coefficient records come from the packed R1CS arrays and go back into
packed rows, so layer one's millions of entries take numpy time.
"""

from __future__ import annotations

import struct
from array import array
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import host
from ..fields import bn254
from ..models.r1cs import R1CS, RowList
from ..ops.curve import DeviceG1Points
from ..ops.fp2 import DeviceG2Points
from ..prover.groth16 import VerifyingKey
from ..prover.setup import ProvingKey, table_points
from . import binfmt

N8 = binfmt.N8
_MONT = binfmt._MONT
# section 4 record: matrix, constraint, signal, Montgomery Fr value
COEFF_RECORD = np.dtype([("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("v", "<u4", (8,))])


def read_sections(path: str, magic: bytes) -> Dict[int, np.ndarray]:
    """Memory-mapped container: {section type: uint8 view of its payload}
    (each type once). Nothing is read until a view is sliced and copied."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if bytes(data[:4]) != magic:
        raise ValueError(f"{path}: bad magic (expected {magic!r})")
    (n_sections,) = struct.unpack("<I", bytes(data[8:12]))
    pos, out = 12, {}
    for _ in range(n_sections):
        stype, size = struct.unpack("<IQ", bytes(data[pos : pos + 12]))
        pos += 12
        if stype in out:
            raise ValueError(f"{path}: duplicate section {stype}")
        if pos + size > data.shape[0]:
            raise ValueError(f"{path}: truncated file")
        out[stype] = data[pos : pos + size]
        pos += size
    return out


def section(sections: Dict[int, np.ndarray], stype: int) -> np.ndarray:
    if stype not in sections:
        raise ValueError(f"missing section {stype}")
    return sections[stype]


def write_container(path: str, magic: bytes, version: int, sections) -> None:
    """sections: (type, payload) with payload bytes or a numpy array."""
    with open(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<II", version, len(sections)))
        for stype, payload in sections:
            f.write(struct.pack("<IQ", stype, memoryview(payload).nbytes))
            f.write(memoryview(payload).cast("B"))


def _points_from_bytes(raw: np.ndarray, count: int, words: int, device):
    """raw bytes of `count` points of `words` 8-limb coordinates each ->
    (coordinates [count, words, 8] int32 on device, valid [count])."""
    need = count * words * N8
    if raw.shape[0] < need:
        raise ValueError(f"section holds {raw.shape[0]} bytes, {need} needed")
    arr = np.array(raw[:need]).view("<u4").view(np.int32).reshape(count, words, 8)
    valid = (arr != 0).reshape(count, -1).any(axis=1)
    return torch.from_numpy(arr).to(device), torch.from_numpy(valid).to(device)


def g1_table(raw: np.ndarray, count: int, device) -> DeviceG1Points:
    arr, valid = _points_from_bytes(raw, count, 2, device)
    return DeviceG1Points(arr[:, 0].contiguous(), arr[:, 1].contiguous(), valid)


def g2_table(raw: np.ndarray, count: int, device) -> DeviceG2Points:
    arr, valid = _points_from_bytes(raw, count, 4, device)
    return DeviceG2Points(arr[:, 0:2].contiguous(), arr[:, 2:4].contiguous(), valid)


def table_bytes(tab: DeviceG1Points) -> np.ndarray:
    """G1 or G2 table -> its section payload (uint8), invalid rows zero."""
    n = len(tab)
    xs = tab.xs.cpu().reshape(n, -1, 8)
    ys = tab.ys.cpu().reshape(n, -1, 8)
    rows = torch.cat([xs, ys], dim=1)
    rows = torch.where(tab.valid.cpu().reshape(n, 1, 1), rows, torch.zeros_like(rows))
    return rows.numpy().view(np.uint8).reshape(-1)


def coeff_records(r1cs) -> np.ndarray:
    """Section 4's records of every A and B term, in row order (A first),
    values as Montgomery Fr limbs: the records `binfmt.write_zkey` packs
    one by one."""
    packed = r1cs.pack()
    pool = [v % bn254.R * _MONT % bn254.R for v in host.limbs_to_ints(packed.pool_limbs)]
    pool_limbs = host.scalars_to_limbs_fast(pool).view(np.uint32)
    recs = []
    for matrix, mat in ((0, packed.a), (1, packed.b)):
        rec = np.empty(len(mat.idx), COEFF_RECORD)
        rec["m"] = matrix
        rec["c"] = mat.idx
        rec["s"] = mat.wire
        rec["v"] = pool_limbs[mat.cid]
        recs.append(rec)
    return np.concatenate(recs)


def write_zkey_device(path: str, pk: ProvingKey, r1cs) -> None:
    """The key with device tables as `binfmt.write_zkey` writes its host
    lists: the same 10 sections, byte for byte."""
    vk = VerifyingKey.from_json(pk.vk_json)
    g1b, g2b = binfmt._g1_bytes, binfmt._g2_bytes
    header2 = (
        struct.pack("<I", N8) + binfmt._fe_bytes(bn254.P)
        + struct.pack("<I", N8) + binfmt._fe_bytes(bn254.R)
        + struct.pack("<III", pk.n_vars, pk.n_public, pk.domain_size)
        + g1b(pk.alpha1) + g1b(pk.beta1) + g2b(pk.beta2) + g2b(vk.gamma_2)
        + g1b(pk.delta1) + g2b(pk.delta2)
    )
    recs = coeff_records(r1cs)
    pad = pk.domain_size - len(pk.h_query)
    h = np.concatenate([table_bytes(pk.h_query), np.zeros(max(pad, 0) * 2 * N8, np.uint8)])
    write_container(path, binfmt.ZKEY_MAGIC, 1, [
        (1, struct.pack("<I", binfmt._GROTH16_PROTOCOL_ID)),
        (2, header2),
        (3, b"".join(g1b(p) for p in vk.ic)),
        (4, struct.pack("<I", recs.shape[0]) + recs.tobytes()),
        (5, table_bytes(pk.a_query)),
        (6, table_bytes(pk.b1_query)),
        (7, table_bytes(pk.b2_query)),
        (8, table_bytes(pk.c_query)),
        (9, h),
        (10, b"\0" * 64 + struct.pack("<I", 0)),
    ])


def _rows_from_records(recs: np.ndarray, n_vars: int, n_public: int) -> R1CS:
    """Section 4's records as an R1CS of packed A and B rows sharing one
    coefficient pool, and no C rows (a .zkey stores none); the rows equal
    `binfmt.r1cs_from_zkey_coeffs` of `read_zkey`'s list."""
    vals = np.ascontiguousarray(recs["v"]).view(np.dtype((np.void, 32))).reshape(-1)
    uniq, inverse = np.unique(vals, return_inverse=True)
    mont_inv = pow(_MONT, -1, bn254.R)
    pool = [int.from_bytes(bytes(u), "little") * mont_inv % bn254.R for u in uniq]
    pool_index = {v: j for j, v in enumerate(pool)}

    def rows(sel) -> RowList:
        out = RowList(pool, pool_index)
        for name, col in (("idx", recs["c"][sel]), ("wire", recs["s"][sel]),
                          ("cid", inverse.reshape(-1)[sel])):
            arr = array("q")
            arr.frombytes(np.ascontiguousarray(col, dtype=np.int64).tobytes())
            setattr(out, name, arr)
        return out

    n_constraints = int(recs["c"].max()) + 1 if recs.shape[0] else 0
    return R1CS(n_wires=n_vars, n_public=n_public, a_rows=rows(recs["m"] == 0),
                b_rows=rows(recs["m"] == 1), c_rows=RowList(pool, pool_index),
                n_constraints=n_constraints)


def read_zkey_device(path: str, device, h_basis: str = "monomial") -> Tuple[ProvingKey, R1CS]:
    """Parse a .zkey into (ProvingKey with its tables on `device`, R1CS of
    section 4's A and B rows). h_basis selects section 9's convention as in
    `binfmt.read_zkey`: 'monomial' (drops the infinity tail), 'coset'
    (refuses infinity points) or 'auto' (monomial if the last point is
    infinity)."""
    secs = read_sections(path, binfmt.ZKEY_MAGIC)
    if struct.unpack("<I", bytes(section(secs, 1)))[0] != binfmt._GROTH16_PROTOCOL_ID:
        raise ValueError("not a Groth16 zkey")
    rd = binfmt._Reader(bytes(section(secs, 2)))
    n8q = rd.u32()
    if rd.fe(n8q) != bn254.P:
        raise ValueError("zkey base field is not BN254 Fq")
    n8r = rd.u32()
    if rd.fe(n8r) != bn254.R:
        raise ValueError("zkey scalar field is not BN254 Fr")
    n_vars, n_public, domain_size = rd.u32(), rd.u32(), rd.u32()
    alpha1 = binfmt._g1_parse(rd.bytes(2 * N8))
    beta1 = binfmt._g1_parse(rd.bytes(2 * N8))
    beta2 = binfmt._g2_parse(rd.bytes(4 * N8))
    gamma2 = binfmt._g2_parse(rd.bytes(4 * N8))
    delta1 = binfmt._g1_parse(rd.bytes(2 * N8))
    delta2 = binfmt._g2_parse(rd.bytes(4 * N8))
    ic_raw = bytes(section(secs, 3))
    ic = [binfmt._g1_parse(ic_raw[i : i + 2 * N8]) for i in range(0, len(ic_raw), 2 * N8)]

    sec4 = section(secs, 4)
    (n_coeffs,) = struct.unpack("<I", bytes(sec4[:4]))
    recs = np.array(sec4[4 : 4 + n_coeffs * COEFF_RECORD.itemsize]).view(COEFF_RECORD)

    def g1(stype):
        raw = section(secs, stype)
        return g1_table(raw, raw.shape[0] // (2 * N8), device)

    h_query = g1(9)
    if h_basis == "auto":
        h_basis = "monomial" if len(h_query) and not bool(h_query.valid[-1]) else "coset"
    if h_basis == "monomial":
        valid = torch.nonzero(h_query.valid.cpu()).flatten()
        keep = int(valid[-1]) + 1 if valid.numel() else 0
        h_query = DeviceG1Points(h_query.xs[:keep], h_query.ys[:keep], h_query.valid[:keep])
    elif h_basis == "coset":
        if not bool(h_query.valid.all()):
            raise ValueError("h_basis='coset' but section 9 contains infinity points — "
                             "this looks like a natively written monomial zkey")
    else:
        raise ValueError(f"unknown h_basis {h_basis!r}")
    raw7 = section(secs, 7)
    vk = VerifyingKey(alpha1, beta2, gamma2, delta2, ic, n_public)
    pk = ProvingKey(
        n_vars=n_vars, n_public=n_public, domain_size=domain_size,
        a_query=g1(5), b1_query=g1(6), c_query=g1(8), h_query=h_query,
        alpha1=alpha1, beta1=beta1, delta1=delta1,
        b2_query=g2_table(raw7, raw7.shape[0] // (4 * N8), device),
        beta2=beta2, delta2=delta2, vk_json=vk.to_json(), h_basis=h_basis,
    )
    return pk, _rows_from_records(recs, n_vars, n_public)


def rows_host(tab: DeviceG1Points, rows: Sequence[int]):
    """Host affine points of a few rows of a G1 or G2 table (None =
    infinity)."""
    idx = torch.as_tensor(list(rows), dtype=torch.int64, device=tab.xs.device)
    return table_points(type(tab)(tab.xs[idx], tab.ys[idx], tab.valid[idx]))
