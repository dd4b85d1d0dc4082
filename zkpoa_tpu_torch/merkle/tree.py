"""Poseidon-Merkle engine on torch tensors: batched tree build over the
anonymity set and inclusion-proof extraction.

Port of `zkpoa_tpu/merkle/tree.py`. Leaf = Poseidon(address, balance),
padded with zero leaves to 2^(height - 1); each level is one batched
Poseidon(2) over the level below (`ops/poseidon_torch.hash2`, kernel B1 on
the card). The levels stay on the device as [n, 8] int32 Montgomery limbs;
the root and the proofs decode only the rows they need. The JSON written
is the JAX package's (the reference's merkle_root.json / merkle_proofs.json,
scripts/merkle_tree.rs:190-204,357-392).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Sequence

import torch

from .. import host
from ..ops import poseidon as poseidon_host
from ..ops import poseidon_torch
from ..ops.limbs import BN254_FR


@dataclass
class MerkleProof:
    leaf: int
    leaf_index: int
    path_elements: List[int]  # sibling hashes, leaf level first
    path_indices: List[int]  # 0 = current node is left child, 1 = right


class MerkleTree:
    """Poseidon(2) Merkle tree. `height` counts levels of nodes including
    the leaf level and the root (a tree over 2^(h-1) leaves has height h,
    the reference's convention)."""

    # pairs per hash2 call: bounds the scratch of one call (the MDS product
    # holds 9 elements of 32 B per pair), ~75 MiB at 2^18
    HASH_CHUNK = 1 << 18

    def __init__(self, levels: List[torch.Tensor]):
        self._levels = levels  # levels[0] = leaves, levels[-1] = root [1, 8]

    @classmethod
    def _hash_level(cls, cur: torch.Tensor) -> torch.Tensor:
        pairs = cur.reshape(-1, 2, 8)
        parts = [poseidon_torch.hash2(p[:, 0], p[:, 1])
                 for p in torch.split(pairs, cls.HASH_CHUNK)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @classmethod
    def from_leaves_mont(cls, leaves: torch.Tensor) -> "MerkleTree":
        n = leaves.shape[0]
        if n & (n - 1):
            raise ValueError("leaf count must be a power of two (pad first)")
        levels = [leaves]
        while levels[-1].shape[0] > 1:
            levels.append(cls._hash_level(levels[-1]))
        return cls(levels)

    @classmethod
    def build(cls, addresses: Sequence[int], balances: Sequence[int], height: int,
              device="cuda") -> "MerkleTree":
        """Leaf = Poseidon(address, balance), padded with zero leaves to
        2^(height-1) (the reference pads with 0, scripts/merkle_tree.rs:256-262)."""
        spec = BN254_FR
        n_leaves = 1 << (height - 1)
        n_real = len(addresses)
        if n_real > n_leaves:
            raise ValueError(f"{n_real} entries exceed 2^{height - 1} leaves")
        enc = lambda vals: spec.to_mont(  # noqa: E731
            torch.from_numpy(host.scalars_to_limbs_fast(vals)).to(device))
        pairs = torch.stack([enc(addresses), enc(balances)], dim=1)
        hashed = [poseidon_torch.hash2(p[:, 0], p[:, 1])
                  for p in torch.split(pairs, cls.HASH_CHUNK)]
        pad = torch.zeros((n_leaves - n_real, 8), dtype=torch.int32, device=device)
        return cls.from_leaves_mont(torch.cat(hashed + [pad]))

    @property
    def height(self) -> int:
        return len(self._levels)

    @property
    def n_leaves(self) -> int:
        return int(self._levels[0].shape[0])

    def root(self) -> int:
        return BN254_FR.decode(self._levels[-1])[0]

    def leaf(self, index: int) -> int:
        return BN254_FR.decode(self._levels[0][index : index + 1])[0]

    def prove(self, index: int) -> MerkleProof:
        if not 0 <= index < self.n_leaves:
            raise IndexError(index)
        sibs, path_indices = [], []
        idx = index
        for level in self._levels[:-1]:
            sibs.append(level[idx ^ 1])
            path_indices.append(idx & 1)
            idx >>= 1
        return MerkleProof(
            leaf=self.leaf(index),
            leaf_index=index,
            path_elements=BN254_FR.decode(torch.stack(sibs)),
            path_indices=path_indices,
        )

    def write_root(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(str(self.root()), f)

    def write_proofs(self, indices: Sequence[int], path: str) -> None:
        proofs = [self.prove(i) for i in indices]
        payload = {
            "root": str(self.root()),
            "leaves": [
                {
                    "address_index": p.leaf_index,
                    "leaf": str(p.leaf),
                    "path_elements": [str(x) for x in p.path_elements],
                    "path_indices": p.path_indices,
                }
                for p in proofs
            ],
        }
        with open(path, "w") as f:
            json.dump(payload, f)


def verify_proof(root: int, proof: MerkleProof) -> bool:
    """Host check mirroring circuits/merkle.circom MerkleProofVerify."""
    node = proof.leaf
    for sib, bit in zip(proof.path_elements, proof.path_indices):
        node = poseidon_host.poseidon2(sib, node) if bit else poseidon_host.poseidon2(node, sib)
    return node == root


def find_owned_indices(anon_addresses: Sequence[int], owned_addresses: Sequence[int]) -> List[int]:
    """Index of each owned address in the anonymity set (raises if one is
    absent; reference scripts/merkle_tree.rs:334-350)."""
    pos = {a: i for i, a in enumerate(anon_addresses)}
    out = []
    for a in owned_addresses:
        if a not in pos:
            raise ValueError(f"owned address {hex(a)} not in anonymity set")
        out.append(pos[a])
    return out
