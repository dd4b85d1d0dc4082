"""LayerTwo(n, h) in the recursive mode (upstream circuits/layer_two.circom):
the in-snark Groth16 verifier of the batch's layer-one proof, the batch's
public keys to addresses (Keccak) and Merkle inclusion at height h, built
as the port's workflow builds it (`_layer_two_input`,
`recursive_layer_two_circuit`) over a seeded anonymity set. Set-up makes
the layer-one key and one layer-one proof a pool witness, each under its
own (r, s), so the verifier witnesses differ."""

from __future__ import annotations

from .. import fixtures
from ..pool import Pool, randomness, same_structure


def build_pool(config: dict, cell: dict, seed: int, device) -> Pool:
    from zkpoa_tpu_torch.merkle.tree import MerkleTree, find_owned_indices
    from zkpoa_tpu_torch.models.layers import LayerOneInput, layer_one_circuit
    from zkpoa_tpu_torch.pipeline.sanitize import sanitize
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures
    from zkpoa_tpu_torch.pipeline.workflow import _layer_two_input, recursive_layer_two_circuit
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    n, size, height = config["n_sigs"], config["anon_set_rows"], config["merkle_height"]
    raw = {"n_sigs": n, "sig_seed": f"{seed}|batch0", "anon_size": size,
           "anon_seed": f"{seed}|anon", "height": height}
    entries = fixtures.signatures(n, raw["sig_seed"])
    atts = parse_signatures(entries)
    rows = fixtures.anon_set(entries, size, raw["anon_seed"])
    addrs = [a for a, _ in rows]
    tree = MerkleTree.build(addrs, [b for _, b in rows], height, device=device)
    root = tree.root()
    paths = [tree.prove(i) for i in find_owned_indices(addrs, [a.address for a in atts])]
    del tree

    inp1 = layer_one_input(atts)
    c1 = layer_one_circuit([LayerOneInput.from_json_entry(inp1, i) for i in range(n)])
    r1, w1 = c1.compile()
    pk1 = setup_device(r1, device, seed=f"poa_bench|{seed}|key1")
    vk1_json = pk1.vk_json
    vk1 = groth16.VerifyingKey.from_json(vk1_json)
    proofs1 = []
    for k in range(cell["pool"]):
        r, s = randomness(seed, f"l1-{k}")
        proofs1.append(prove(pk1, r1, w1, device, r=r, s=s))
    del pk1, r1, w1

    r1cs, witnesses = None, []
    for p1 in proofs1:
        inp2 = _layer_two_input(atts, paths, root, height)
        inp2.proof = sanitize(vk1, p1, c1.public_values)
        r2, w2 = recursive_layer_two_circuit(inp2, vk1_json, height).compile()
        if r1cs is None:
            r1cs = r2
        elif not same_structure(r2, r1cs):
            raise RuntimeError("the pool's verifier witnesses built different constraint systems")
        witnesses.append(w2)
    key_seed = f"poa_bench|{seed}|key"
    key = setup_device(r1cs, device, seed=key_seed)
    return Pool("recursive_layer_two", r1cs, witnesses, [raw] * len(witnesses), key, key_seed)
