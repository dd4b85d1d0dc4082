"""Packed numpy form of an R1CS for the device SpMV.

Port of the body of `zkpoa_tpu/models/r1cs.py:232-` `R1CS.pack`, whose only
JAX dependency is its import of `msm_pallas.scalars_to_limbs_fast`. The
coefficient pool is stored as the port's 8 x 32-bit plain limbs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkpoa_tpu.models.r1cs import R1CS, RowList, _pack_rows

from ..host import scalars_to_limbs_fast


@dataclass
class PackedMatrix:
    """One sparse matrix as parallel int32 arrays: constraint index, wire
    index, coefficient-pool id."""

    idx: np.ndarray
    wire: np.ndarray
    cid: np.ndarray


@dataclass
class PackedR1CS:
    a: PackedMatrix
    b: PackedMatrix
    c: PackedMatrix
    pool_limbs: np.ndarray  # [n_pool, 8] int32 plain limbs
    n_wires: int
    n_public: int
    n_constraints: int


def pack(r1cs: R1CS) -> PackedR1CS:
    """Packed form of `r1cs` (cached on the object). RowList-backed
    circuits convert with no per-row Python work."""
    cached = getattr(r1cs, "_packed_torch", None)
    if cached is not None:
        return cached
    pool_index: dict = {}
    pool_vals: list = []
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        if isinstance(rows, RowList):
            assert not pool_vals or pool_vals is rows.pool, "mixed RowList pools in one R1CS"
            pool_vals = rows.pool
            pool_index = rows.pool_index
    if not pool_vals:
        pool_vals = [1]
        pool_index = {1: 0}

    def pm(rows) -> PackedMatrix:
        if isinstance(rows, RowList):
            return PackedMatrix(
                idx=np.frombuffer(rows.idx, dtype=np.int64).astype(np.int32),
                wire=np.frombuffer(rows.wire, dtype=np.int64).astype(np.int32),
                cid=np.frombuffer(rows.cid, dtype=np.int64).astype(np.int32),
            )
        m = _pack_rows(rows, pool_index, pool_vals)
        return PackedMatrix(m.idx, m.wire, m.cid)

    a, b, c = pm(r1cs.a_rows), pm(r1cs.b_rows), pm(r1cs.c_rows)
    packed = PackedR1CS(
        a=a, b=b, c=c,
        pool_limbs=scalars_to_limbs_fast(pool_vals),
        n_wires=r1cs.n_wires, n_public=r1cs.n_public,
        n_constraints=r1cs.n_constraints,
    )
    object.__setattr__(r1cs, "_packed_torch", packed)
    return packed
