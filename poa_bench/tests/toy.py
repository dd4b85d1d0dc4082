"""A toy cell for the CPU tests: Poseidon(x, y) as a one-output circuit
(244 constraints, domain 2^8) through the program's frontend and setup,
x and y from the seed. Its kind is registered as `toy` with the circuit
kinds and the reference's public values."""

from __future__ import annotations

import json
import os
import shutil
import sys
import types

from poa_bench.pool import Pool, same_structure

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = {}


def build_one(config, batch_seed):
    from zkpoa_tpu_torch.models import r1cs as R1
    from zkpoa_tpu_torch.models.gadgets import poseidon_gadget

    x, y = (sum(map(ord, f"{batch_seed}|{k}")) for k in "xy")
    c = R1.Circuit()
    out = c.public_output()
    c.bind_output(out, poseidon_gadget.poseidon(c, [c.var(x), c.var(y)]))
    r1cs, witness = c.compile()
    return r1cs, witness, {"x": x, "y": y}


def build_pool(config, cell, seed, device):
    from zkpoa_tpu_torch.prover.setup import setup_device

    builds = [build_one(config, f"{seed}|batch{k}") for k in range(cell["pool"])]
    r1cs = builds[0][0]
    assert all(same_structure(b[0], r1cs) for b in builds[1:])
    key_seed = f"poa_bench|{seed}|key"
    if key_seed not in _KEYS:  # one CPU setup (~12 s) a seed
        _KEYS[key_seed] = setup_device(r1cs, device, seed=key_seed)
    return Pool("toy", r1cs, [b[1] for b in builds], [b[2] for b in builds],
                _KEYS[key_seed], key_seed)


def expected_publics(raw):
    from poa_bench.reference.poseidon import poseidon

    return [poseidon([raw["x"], raw["y"]])]


def install(monkeypatch, tmp_path, traffic="closed_loop", warmup=0, traced=1):
    """Register the toy kind and write a toy cell's files under tmp_path;
    returns (bench, pkg)."""
    this = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, "poa_bench.circuits.toy", this)
    monkeypatch.setitem(sys.modules, "poa_bench.reference.toy", this)
    for d in ("workloads", "configs"):
        os.makedirs(tmp_path / d, exist_ok=True)
    shutil.copytree(os.path.join(PKG, "specs"), tmp_path / "specs", dirs_exist_ok=True)
    (tmp_path / "configs" / "toy.json").write_text(json.dumps({"circuit": "toy", "n_sigs": 1}))
    (tmp_path / "workloads" / "toy.run.json").write_text(json.dumps(
        {"config": "toy", "traffic": traffic, "pool": 2, "warmup": warmup,
         "traced_requests": traced}))
    with open(os.path.join(os.path.dirname(PKG), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": "toy.run", "config": "toy", "traffic": traffic, "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["toy.run"]
    return bench, str(tmp_path)
