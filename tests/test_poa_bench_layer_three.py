"""The benchmark's recursive layer three (`poa_bench/circuits/` and
`poa_bench/reference/recursive_layer_three.py`): the reference's public
values against a recorded run and against the port's own layer-three
circuit, its check of the commitment's registers, and the cell's files
found by name."""

import ast
import csv
import importlib
import json
import os
import random

import pytest

from poa_bench import fixtures
from poa_bench.reference import judge
from poa_bench.reference import recursive_layer_three as L3
from poa_bench.reference.bn254 import R
from poa_bench.reference.recursive_layer_two import merkle_root
from zkpoa_tpu_torch.models.layers import layer_three_circuit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "build", "recursive_run2")
RECORDED = os.path.join(RUN, "2_sigs_2_batches_5_height")
CELL = "l3r_k2.prove"
FORBIDDEN = {"jax", "jaxlib", "flax", "zkpoa_tpu"}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_reference_gives_the_recorded_runs_public_values():
    """The recorded chain's layer three: batch sums from its layer-two
    publics, its anonymity set at height 5, blinding factor 0xB11DD1E5."""
    want = [int(x) for x in _load(RECORDED, "layer_three", "public.json")]
    sums = [int(_load(RECORDED, f"batch_{b}", "public.json")[0]) for b in range(2)]
    with open(os.path.join(RUN, "anon.csv")) as f:
        rows = [(int(r["address"], 16), int(r["balance"])) for r in csv.DictReader(f)]
    root = merkle_root(rows, 5)
    assert root == int(_load(RECORDED, "merkle_root.json"))
    assert L3.registers(sum(sums), 0xB11DD1E5) + [root] == want


@pytest.mark.parametrize("seed,blind", [
    (1, 0), (2, 2**255 - 1), (3, None), (4, None)], ids=["blind0", "blind-max", "s3", "s4"])
def test_reference_registers_are_the_ports_public_values(seed, blind):
    """The port's layer three without the in-snark verifiers (the
    commitment and the root) on seeded balances, roots and blinds; seed 4
    commits to the largest total a field element holds, r - 1."""
    rng = random.Random(seed)
    if seed == 4:
        balances = [2**253, R - 1 - 2**253]
    else:
        balances = [rng.randrange(1 << 64) for _ in range(2)]
    blind = rng.randrange(1 << 255) if blind is None else blind
    root = rng.randrange(1 << 253)
    got = [int(x) for x in layer_three_circuit(balances, root, blind).public_values]
    assert L3.registers(sum(balances), blind) + [root] == got


def test_expected_publics_follow_the_ports_build_of_the_same_seeds():
    """expected_publics of a small raw (2 batches of 2, 12 rows, height 5)
    against the port's Merkle tree over the same rows and its layer three
    over the batches' balances."""
    from zkpoa_tpu_torch.merkle.tree import MerkleTree
    from zkpoa_tpu_torch.pipeline.sigs import parse_signatures

    raw = {"n_sigs": 2, "sig_seeds": ["7|batch0", "7|batch1"], "anon_size": 12,
           "anon_seed": "7|anon", "height": 5, "blind_seed": "7|blind0"}
    entries = [fixtures.signatures(2, s) for s in raw["sig_seeds"]]
    rows = fixtures.anon_set([e for b in entries for e in b], 12, raw["anon_seed"])
    assert {int(e["address"], 16) for b in entries for e in b} <= {a for a, _ in rows}
    root = MerkleTree.build([a for a, _ in rows], [b for _, b in rows], 5, device="cpu").root()
    sums = [sum(a.balance for a in parse_signatures(b)) for b in entries]
    blind = L3.blinding_factor(raw["blind_seed"])
    assert blind.bit_length() <= 255 and blind != L3.blinding_factor("7|blind1")
    got = [int(x) for x in layer_three_circuit(sums, root, blind).public_values]
    assert judge.expected_publics("recursive_layer_three", raw) == got


@pytest.mark.parametrize("index", range(12))
def test_register_check_refuses_one_altered_register(index):
    total, blind = 123456789, 0xB11DD1E5
    regs = L3.registers(total, blind)
    point = L3.commitment(total, blind)
    L3.check_registers(regs, point)
    regs[index] += 1
    with pytest.raises(ValueError):
        L3.check_registers(regs, point)


def test_generators_and_curve_constant():
    """d = -121665 / 121666; both generators on the curve; g is the ed25519
    base point, whose y is 4/5."""
    g, h = L3.affine(L3.G_EXT), L3.affine(L3.H_EXT)
    assert L3.on_curve(g) and L3.on_curve(h) and g != h
    assert g[1] == 4 * pow(5, -1, L3.P) % L3.P
    assert L3.mul(g, 2**252 + 27742317777372353535851937790883648493) == L3.IDENTITY


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_cell_resolves_by_name_and_imports_no_jax():
    bench = _load(ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    spec = _load(ROOT, "poa_bench", "workloads", f"{CELL}.json")
    assert (spec["config"], spec["traffic"]) == (entry["config"], entry["traffic"])
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load(ROOT, conf["file"])
    assert config["reduced"] == conf["reduced"] == [] and config["source"] == conf["source"]
    kind = config["circuit"]
    assert kind == "recursive_layer_three"
    circuit = importlib.import_module(f"poa_bench.circuits.{kind}")
    reference = importlib.import_module(f"poa_bench.reference.{kind}")
    assert callable(circuit.build_pool) and callable(reference.expected_publics)
    assert not set(_imports(circuit.__file__)) & FORBIDDEN
    assert not set(_imports(reference.__file__)) & (FORBIDDEN | {"zkpoa_tpu_torch"})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", [CELL]):
            reader = _load(ROOT, "poa_bench", "specs", f"{m['name']}.json")["reader"]
            assert callable(importlib.import_module(f"poa_bench.metrics.{reader}").read)
