# Copy of zkpoa_tpu/pipeline/pedersen_check.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Final end-to-end assertion: recompute the Pedersen commitment from the
secrets and compare it (projective point equality) against the layer-3
public signals.

Role of the reference's scripts/pedersen_commitment_checker.ts:47-63 — the
prover-side sanity gate at the end of full_workflow.sh (:588-591)."""

from __future__ import annotations

from typing import Sequence, Tuple

from ..fields import curve25519 as C
from ..utils.serde import from_limbs_85x3


def dechunk_commitment(public_signals: Sequence[int]) -> C.ExtPoint:
    """First 12 public signals -> extended point (4 coords x 3 x 85-bit
    registers, scripts/lib/pedersen_commitment.ts dechunkToPoint)."""
    regs = [int(x) for x in public_signals[:12]]
    return tuple(from_limbs_85x3(regs[i * 3 : (i + 1) * 3]) for i in range(4))  # type: ignore


def check_commitment(
    public_signals: Sequence[int], balance_sum: int, blinding_factor: int
) -> bool:
    """True iff the layer-3 output commits to balance_sum with
    blinding_factor."""
    expected = C.pedersen_commitment(balance_sum, blinding_factor)
    return C.point_equal(dechunk_commitment(public_signals), expected)
