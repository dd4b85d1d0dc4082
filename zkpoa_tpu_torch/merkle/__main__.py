"""Merkle engine CLI, the reference's Rust `merkle-tree` binary interface
(scripts/merkle_tree.rs:31-44):

    python -m zkpoa_tpu_torch.merkle --anon-set anon.csv \
        [--poa-input-data input_data.json] [--output-dir DIR] [--height H] [--device cuda]

Port of `zkpoa_tpu/merkle/__main__.py`: builds the Poseidon Merkle tree over
the anonymity set on `--device` (default cuda) and writes merkle_root.json,
plus merkle_proofs.json for the owned addresses when input data is given.
"""

from __future__ import annotations

import argparse
import os
import time

from ..pipeline import planner
from ..pipeline.workflow import load_anon_set
from ..prover.prove import _sync
from ..utils import serde
from .tree import MerkleTree, find_owned_indices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Poseidon-Merkle tree builder (PyTorch/CUDA)")
    ap.add_argument("--anon-set", required=True, help="CSV (address,balance)")
    ap.add_argument("--poa-input-data", default=None,
                    help="ProofOfAssetsInputFileShape JSON (owned accounts)")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for small sets)")
    args = ap.parse_args(argv)

    addrs, bals = load_anon_set(args.anon_set)
    height = args.height or planner.merkle_height(len(addrs))
    t0 = time.time()
    tree = MerkleTree.build(addrs, bals, height, device=args.device)
    _sync(args.device)
    root = tree.root()
    print(f"built tree: {len(addrs)} leaves, height {height}, "
          f"{time.time() - t0:.2f}s, root {root}")

    os.makedirs(args.output_dir, exist_ok=True)
    tree.write_root(os.path.join(args.output_dir, "merkle_root.json"))
    if args.poa_input_data:
        data = serde.load_tagged(args.poa_input_data)
        owned = [int(acc["accountData"]["address"]) for acc in data["accountAttestations"]]
        idx = find_owned_indices(addrs, owned)
        tree.write_proofs(idx, os.path.join(args.output_dir, "merkle_proofs.json"))
        print(f"wrote {len(idx)} inclusion proofs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
