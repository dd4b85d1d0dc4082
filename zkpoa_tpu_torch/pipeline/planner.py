# Copy of zkpoa_tpu/pipeline/planner.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Batch-size planning: split N signatures into k batches of size b chosen
to minimize the leftover remainder batch.

Role of the reference's scripts/batch_size_optimizooor.py (invoked from
full_workflow.sh:180-187): zkey generation cost scales with circuit size,
and the remainder batch needs its own circuit + zkey, so the remainder is
minimized. Same closed-form math, re-derived: consider using one more or
one fewer full batch and pick the batch size with the smaller adjustment."""

from __future__ import annotations

import math
from dataclasses import dataclass


def batch_size(num_sigs: int, ideal_batch_size: int) -> int:
    """Adjusted batch size minimizing the remainder batch."""
    if num_sigs <= 0:
        raise ValueError("num_sigs must be positive")
    if ideal_batch_size <= 0:
        raise ValueError("ideal_batch_size must be positive")
    if num_sigs < ideal_batch_size:
        return num_sigs
    diff_pos = math.ceil(
        ideal_batch_size - num_sigs / (math.floor(num_sigs / ideal_batch_size) + 1)
    )
    diff_neg = math.ceil(
        ideal_batch_size - num_sigs / math.floor(num_sigs / ideal_batch_size)
    )
    if diff_pos < abs(diff_neg):
        return ideal_batch_size - diff_pos
    return ideal_batch_size - diff_neg


@dataclass(frozen=True)
class BatchPlan:
    num_sigs: int
    batch_size: int
    num_full_batches: int
    remainder: int

    @property
    def num_batches(self) -> int:
        return self.num_full_batches + (1 if self.remainder else 0)

    def batch_range(self, i: int):
        """[start, end) signature indices of batch i."""
        start = i * self.batch_size
        end = min(start + self.batch_size, self.num_sigs)
        return start, end

    def batch_sizes(self):
        return [self.batch_range(i)[1] - self.batch_range(i)[0] for i in range(self.num_batches)]


def plan(num_sigs: int, ideal_batch_size: int) -> BatchPlan:
    b = batch_size(num_sigs, ideal_batch_size)
    return BatchPlan(
        num_sigs=num_sigs,
        batch_size=b,
        num_full_batches=num_sigs // b,
        remainder=num_sigs % b,
    )


def merkle_height(anon_set_size: int) -> int:
    """ceil(log2(n)) + 1 (full_workflow.sh:147-152 convention: height
    counts node levels including leaves and root)."""
    if anon_set_size <= 0:
        raise ValueError("empty anonymity set")
    return max(1, math.ceil(math.log2(anon_set_size))) + 1
