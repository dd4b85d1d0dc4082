"""LayerOne(n) (upstream circuits/layer_one.circom) over seeded signature
batches, built as the port's workflow builds it, under the port's
development key from the run's seed."""

from __future__ import annotations

from .. import fixtures
from ..pool import Pool, same_structure


def build_one(config: dict, batch_seed: str):
    """(R1CS, witness, raw seeds) of one batch of config['n_sigs'] signatures."""
    from zkpoa_tpu_torch.models.layers import LayerOneInput, layer_one_circuit
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures

    n = config["n_sigs"]
    inp = layer_one_input(parse_signatures(fixtures.signatures(n, batch_seed)))
    r1cs, witness = layer_one_circuit(
        [LayerOneInput.from_json_entry(inp, i) for i in range(n)]).compile()
    return r1cs, witness, {"n_sigs": n, "sig_seed": batch_seed}


def build_pool(config: dict, cell: dict, seed: int, device) -> Pool:
    from zkpoa_tpu_torch.prover.setup import setup_device

    builds = [build_one(config, f"{seed}|batch{k}") for k in range(cell["pool"])]
    r1cs = builds[0][0]
    if not all(same_structure(b[0], r1cs) for b in builds[1:]):
        raise RuntimeError("the pool's batches built different constraint systems")
    key_seed = f"poa_bench|{seed}|key"
    key = setup_device(r1cs, device, seed=key_seed)
    return Pool("layer_one", r1cs, [b[1] for b in builds], [b[2] for b in builds], key, key_seed)
