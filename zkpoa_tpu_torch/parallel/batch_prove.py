"""Batch-parallel proving: the reference's `seq 0 k-1 | parallel
prove_layers_one_two` (scripts/full_workflow.sh:552) on a mesh "batch"
axis: independent proofs of the SAME circuit shape, one contiguous block of
witnesses a rank, the proving key held by every rank.

Port of `zkpoa_tpu/parallel/batch_prove.py`. A rank proves its block
`CHUNK` witnesses at a time through the prover's own `_prove_device`: one
stacked quotient (the NTT pass kernel transforms the leading axis as a
batch, `ops/ntt.py`), then every MSM of the chunk on the port's
per-witness plans in one `msm_many` a group. The proofs are gathered with
`all_gather_object`, so every rank returns all of them, in order. The
JAX package pads a short block to the block size, since its batch is one
array sharded evenly; here each rank proves its own block, so a short
block is simply proved short.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import host
from ..ops import msm as M
from ..prover.groth16 import Proof
from ..prover.prove import _prove_device
from ..prover.setup import ProvingKey
from .mesh import _block, axis_size, gather_objects

# Witnesses a rank proves at once: their QAP operands, quotient and MSM
# plans are held together, about 0.8 GiB of device memory a witness above
# a single prove at 2^21 (layer one, 1 signature).
CHUNK = 2


def msm_batch_parallel(curve, table, scalars_nb: torch.Tensor, mesh: DeviceMesh,
                       axis: str = "batch") -> List:
    """One MSM per batch [NB, N, 8] (plain limbs) over the mesh's batch
    axis: the table held by every rank, this rank's block of batches in
    one `msm_many`, the results gathered. Returns NB host points on every
    rank (NB must divide into the axis's ranks)."""
    block = scalars_nb[_block(scalars_nb.shape[0], mesh, axis)]
    plans = [M.plan_msm(sc.contiguous()) for sc in block]
    parts = M.msm_many(curve, [(table, p, 0) for p in plans])
    return [pt for part in gather_objects(parts, mesh.get_group(axis)) for pt in part]


def _vk_digest(pk: ProvingKey) -> str:
    return hashlib.sha256(json.dumps(pk.vk_json, sort_keys=True).encode()).hexdigest()


def prove_batched(pk: ProvingKey, r1cs, witnesses: Sequence[Sequence[int]], mesh: DeviceMesh,
                  seed: str = "zkpoa-proof", axis: str = "batch",
                  seeds: Optional[Sequence[str]] = None) -> List[Proof]:
    """Prove the SAME circuit for several witnesses over the batch axis of
    `mesh` (the reference's per-batch GNU-parallel fan-out). Rank i of the
    axis proves the i-th contiguous block of ceil(len / axis size)
    witnesses (the last blocks may be short or empty), `CHUNK` witnesses
    at a time through `prove.py` `_prove_device`. Every rank of the world
    calls it with the same key (checked by the verifying key's digest;
    ranks outside the mesh prove nothing) and gets one Proof per witness,
    identical to sequential `prove` calls with seeds f"{seed}-b{i}" (or
    the explicit per-witness `seeds`)."""
    nb = len(witnesses)
    for w in witnesses:
        assert len(w) == pk.n_vars
    digests = set(gather_objects(_vk_digest(pk)))
    if len(digests) > 1:
        raise ValueError(f"the ranks hold {len(digests)} different keys")
    seeds = list(seeds) if seeds is not None else [f"{seed}-b{i}" for i in range(nb)]
    mine = []
    if mesh.get_coordinate() is not None:
        per = -(-nb // axis_size(mesh, axis))
        lo = mesh.get_local_rank(axis) * per
        hi = min(lo + per, nb)
        for i in range(lo, hi, CHUNK):
            ids = range(i, min(i + CHUNK, hi))
            rs = [(host._rand_fr(seeds[j], "r"), host._rand_fr(seeds[j], "s")) for j in ids]
            proofs = _prove_device(pk, r1cs, [witnesses[j] for j in ids], rs,
                                   pk.a_query.xs.device, None)
            mine += zip(ids, proofs)
    done = dict(pair for part in gather_objects(mine) for pair in part)
    return [done[i] for i in range(nb)]
