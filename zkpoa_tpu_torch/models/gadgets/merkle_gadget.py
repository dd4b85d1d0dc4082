# Copy of zkpoa_tpu/models/gadgets/merkle_gadget.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Merkle inclusion proof verification in-circuit.

Equivalent of circuits/merkle.circom MerkleProofVerify (from 0xPARC/cabal):
per level, a boolean path bit selects (node, sibling) order via DualMux,
then Poseidon(2) hashes up; the final hash is constrained equal to the root.
"""

from __future__ import annotations

from typing import List, Sequence

from ..r1cs import AnyLC, Circuit, _lc
from .core import dual_mux
from .poseidon_gadget import poseidon


def merkle_verify(
    c: Circuit,
    leaf: AnyLC,
    root: AnyLC,
    path_elements: Sequence[AnyLC],
    path_indices: Sequence[AnyLC],
) -> None:
    """Constrain that `leaf` sits in the tree with `root` along the given
    path (path_indices bit i: 0 = node is left child at level i)."""
    assert len(path_elements) == len(path_indices)
    node = _lc(leaf)
    for sib, bit in zip(path_elements, path_indices):
        bit = _lc(bit)
        c.constrain(bit, bit - 1, 0)  # boolean
        left, right = dual_mux(c, node, sib, bit)
        node = poseidon(c, [left, right])
    c.assert_equal(node, root)
