"""LayerThree(k) in the recursive mode (upstream circuits/layer_three.circom):
the in-snark Groth16 verifiers of the k batches' layer-two proofs, each
bound to its batch's balance sum and the Merkle root, and the Curve25519
Pedersen commitment to the total, built as the port's workflow builds
its recursive mode (`run_workflow`). Set-up runs the chain before it:
the batches' signatures over one seeded anonymity set that holds all of
their addresses, one layer-one key and a layer-one proof a batch, the
batches' recursive layer-two circuits under one layer-two key. Pool
witness j verifies each batch's layer-two proof under its own (r, s) and
commits under its own blinding factor, so the witnesses differ in the
verifiers' values and in the commitment."""

from __future__ import annotations

import gc

from .. import fixtures
from ..pool import Pool, randomness, same_structure
from ..reference.recursive_layer_three import blinding_factor


def _first(kept, system, what: str):
    """The first of a list of constraint systems, each of which must be it."""
    if kept is not None and not same_structure(system, kept):
        raise RuntimeError(f"the {what} built different constraint systems")
    return system if kept is None else kept


def build_pool(config: dict, cell: dict, seed: int, device) -> Pool:
    import torch

    from zkpoa_tpu_torch.merkle.tree import MerkleTree, find_owned_indices
    from zkpoa_tpu_torch.models.gadgets.pairing_gadget import PreparedVK
    from zkpoa_tpu_torch.models.layers import (LayerOneInput, layer_one_circuit,
                                               layer_three_circuit)
    from zkpoa_tpu_torch.pipeline.sanitize import sanitize
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures
    from zkpoa_tpu_torch.pipeline.workflow import _layer_two_input, recursive_layer_two_circuit
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    n, size, height = config["n_sigs"], config["anon_set_rows"], config["merkle_height"]
    sig_seeds = [f"{seed}|batch{b}" for b in range(config["batches"])]
    entries = [fixtures.signatures(n, s) for s in sig_seeds]
    atts = [parse_signatures(e) for e in entries]
    anon_seed = f"{seed}|anon"
    rows = fixtures.anon_set([e for batch in entries for e in batch], size, anon_seed)
    addrs = [a for a, _ in rows]
    tree = MerkleTree.build(addrs, [b for _, b in rows], height, device=device)
    root = tree.root()
    paths = [[tree.prove(i) for i in find_owned_indices(addrs, [a.address for a in batch])]
             for batch in atts]
    del tree

    # layer one: one key, one proof a batch
    r1, l1 = None, []
    for batch in atts:
        inp1 = layer_one_input(batch)
        c1 = layer_one_circuit([LayerOneInput.from_json_entry(inp1, i) for i in range(n)])
        r1_b, w1 = c1.compile()
        r1 = _first(r1, r1_b, "batches' layer-one circuits")
        l1.append((w1, c1.public_values))
    pk1 = setup_device(r1, device, seed=f"poa_bench|{seed}|key1")
    vk1_json = pk1.vk_json
    vk1 = groth16.VerifyingKey.from_json(vk1_json)
    san1 = []
    for b, (w1, pub1) in enumerate(l1):
        r, s = randomness(seed, f"l1-b{b}")
        san1.append(sanitize(vk1, prove(pk1, r1, w1, device, r=r, s=s), pub1))
    del pk1, r1, l1

    # layer two: one circuit a batch, one key, a proof a batch and pool witness
    r2, l2 = None, []
    for b, batch in enumerate(atts):
        inp2 = _layer_two_input(batch, paths[b], root, height)
        inp2.proof = san1[b]
        c2 = recursive_layer_two_circuit(inp2, vk1_json, height)
        r2_b, w2 = c2.compile()
        r2 = _first(r2, r2_b, "batches' layer-two circuits")
        l2.append((w2, c2.public_values))
        del c2, r2_b
    pk2 = setup_device(r2, device, seed=f"poa_bench|{seed}|key2")
    vk2 = groth16.VerifyingKey.from_json(pk2.vk_json)
    pvk2 = PreparedVK.from_vk(vk2)
    sums = [int(pub2[0]) for _w, pub2 in l2]
    inners = []
    for k in range(cell["pool"]):
        inner = []
        for b, (w2, pub2) in enumerate(l2):
            r, s = randomness(seed, f"l2-b{b}-{k}")
            inner.append((pvk2, sanitize(vk2, prove(pk2, r2, w2, device, r=r, s=s), pub2)))
        inners.append(inner)
    del pk2, r2, l2
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    r1cs, witnesses, raws = None, [], []
    for k, inner in enumerate(inners):
        blind_seed = f"{seed}|blind{k}"
        c3 = layer_three_circuit(sums, root, blinding_factor(blind_seed), inner=inner)
        r3, w3 = c3.compile()
        del c3
        r1cs = _first(r1cs, r3, "pool's layer-three witnesses")
        witnesses.append(w3)
        raws.append({"n_sigs": n, "sig_seeds": sig_seeds, "anon_size": size,
                     "anon_seed": anon_seed, "height": height, "blind_seed": blind_seed})
        del r3
    key_seed = f"poa_bench|{seed}|key"
    key = setup_device(r1cs, device, seed=key_seed)
    return Pool("recursive_layer_three", r1cs, witnesses, raws, key, key_seed)
