"""End-to-end proof-of-assets workflow of the port: the orchestrator.

Port of `zkpoa_tpu/pipeline/workflow.py` (`run_workflow` :98, CLI :576),
the role of the reference's scripts/full_workflow.sh: parse the
custodian's signatures, plan batches, build the anonymity-set Merkle tree,
prove each batch through layers one and two, aggregate with layer three,
and run the final Pedersen-commitment assertion. Every setup, proof and
tree runs on `device` (default `cuda`); files are written at each stage
in the reference's JSON shapes.

  * `mode="accounting"` proves the membership/aggregation statements only;
    `mode="full"` builds the complete layer circuits (in-circuit ECDSA*,
    Keccak address derivation, Poseidon-Merkle inclusion, the in-circuit
    Pedersen commitment); `mode="recursive"` also verifies every
    lower-layer proof inside the next circuit. In every mode the host
    pairing verifier checks each proof.
  * Proving keys come from the development setup or, with `ptau_path`,
    from a powers-of-tau ceremony file plus the optional phase-2
    contribution and beacon (`prover/ptau.py`), cached by circuit shape in
    `zkey_cache` (`prover/cache.py`).
  * One process: batches of one shape are proved in turn against one key,
    and the Merkle tree is built on the main thread (a second host thread
    would only contend with circuit building for the interpreter lock).
    Under `torchrun --nproc-per-node k` (one card a rank) every rank runs
    the same deterministic workflow and each shape's batches are proved
    by `parallel/batch_prove.py` `prove_batched` over a "batch" mesh, a
    block a rank (the JAX package's `_prove_many`); rank 0's build
    directory is the output, the other ranks write into a private scratch
    directory, only read the key cache, and log nothing.

CLI, the reference's 3-argument contract (full_workflow.sh:43):
    python -m zkpoa_tpu_torch.pipeline.workflow <sigs.json> <anon_set.csv> <blind>
        [-b BUILD_DIR] [-p IDEAL_BATCH_SIZE] [-m MODE] [-z ZKEY_CACHE]
        [-H TREE_HEIGHT] [-r] [--profile] [--device cuda|cpu]
        [--ptau FILE [--contribute ENTROPY] [--beacon HASH]]
On k cards: torchrun --nproc-per-node k -m zkpoa_tpu_torch.pipeline.workflow ...
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import _build
from ..fields import curve25519 as C
from ..merkle.tree import MerkleTree, find_owned_indices
from ..models.layers import (
    LayerOneInput,
    LayerTwoInput,
    MembershipWitnessInput,
    layer_one_circuit,
    layer_three_circuit,
    layer_two_circuit,
    membership_sum_circuit,
)
from ..ops import poseidon as poseidon_host
from ..parallel import mesh as PM
from ..parallel.batch_prove import prove_batched
from ..prover import groth16
from ..prover.cache import cached_setup
from ..prover.prove import prove
from ..utils.serde import to_limbs_64x4
from ..utils.trace import Tracer
from . import planner
from .pedersen_check import check_commitment, dechunk_commitment
from .sanitize import sanitize
from .sigs import AccountAttestation, layer_one_input, parse_signatures_file


@dataclass
class WorkflowResult:
    build_dir: str
    num_sigs: int
    num_batches: int
    merkle_height: int
    merkle_root: int
    balance_sum: int
    commitment: tuple
    layer_three_public: List[int]
    timings: Dict[str, float] = field(default_factory=dict)
    # circuit -> constraint count ("layer_one batch 0", ..., "layer_three")
    constraints: Dict[str, int] = field(default_factory=dict)
    # stage -> peak host RSS and peak device memory, MB (utils/trace.py)
    peaks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # batch layers loaded from an earlier run's files ("layer_two batch 0")
    # and proving keys loaded from the key cache (their names): a run with
    # either did not time every stage
    resumed: List[str] = field(default_factory=list)
    cached_keys: List[str] = field(default_factory=list)


def _log(msg: str) -> None:
    print(f"[zkpoa-torch] {msg}", flush=True)


def load_anon_set(path: str):
    """CSV with header 'address,...' rows of (hex address, balance)."""
    addresses, balances = [], []
    with open(path) as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if not row:
            continue
        addresses.append(int(row[0], 16))
        balances.append(int(row[1]))
    order = sorted(range(len(addresses)), key=lambda i: addresses[i])
    return [addresses[i] for i in order], [balances[i] for i in order]


def run_workflow(
    sigs_path: str,
    anon_set_path: str,
    blinding_factor: int,
    build_root: str = "build",
    ideal_batch_size: int = 2,
    mode: str = "accounting",
    zkey_cache: Optional[str] = None,
    tree_height: Optional[int] = None,
    setup_seed: str = "zkpoa-test-srs",
    profile: bool = False,
    resume: bool = False,
    device: str = "cuda",
    ptau_path: Optional[str] = None,
    contribute_entropy: Optional[str] = None,
    beacon_hash: Optional[str] = None,
) -> WorkflowResult:
    if (contribute_entropy or beacon_hash) and not ptau_path:
        raise ValueError(
            "contribute_entropy/beacon_hash require ptau_path — phase-2 "
            "randomization is only applied to a ceremony-derived key")
    tracer = Tracer(log_dir=None, profile=profile)
    timings = tracer.timings

    # -- input preparation (reference L4) ---------------------------------
    with tracer.stage("parse signatures"):
        atts = parse_signatures_file(sigs_path)
    with tracer.stage("load anonymity set"):
        anon_addrs, anon_bals = load_anon_set(anon_set_path)

    n = len(atts)
    bplan = planner.plan(n, ideal_batch_size)
    height = tree_height or planner.merkle_height(len(anon_addrs))
    build_dir = os.path.join(build_root, f"{n}_sigs_{bplan.num_batches}_batches_{height}_height")
    os.makedirs(build_dir, exist_ok=True)
    tracer.__init__(log_dir=os.path.join(build_dir, "logs"), profile=profile, timings=timings)
    _log(f"{n} sigs, batch size {bplan.batch_size} x {bplan.num_batches} batches"
         f" (remainder {bplan.remainder}), tree height {height}, mode={mode}, device={device}")

    # benchmarks.txt (the reference's tests/*/benchmarks.txt) is rewritten
    # after every constraint count and at every stage exit, so a run that
    # dies mid-prove still leaves what it completed
    bench_path = os.path.join(build_dir, "benchmarks.txt")
    bench_lines: List[str] = []
    constraints: Dict[str, int] = {}

    def _flush_bench():
        with open(bench_path, "w") as f:
            f.write(f"config: {n}_sigs_{bplan.num_batches}_batches_{height}_height"
                    f" mode={mode}\n\nconstraints:\n")
            for line in bench_lines:
                f.write(f"  {line}\n")
            f.write("\nstage timings (s):\n")
            for key, v in timings.items():
                f.write(f"  {key}: {v:.2f}\n")

    def _bench(line: str) -> None:
        bench_lines.append(line)
        _flush_bench()

    @contextlib.contextmanager
    def Stage(name):
        try:
            with tracer.stage(name):
                yield
        finally:
            _flush_bench()

    # -- Merkle engine (reference L5, the Rust merkle-tree binary) --------
    with Stage("merkle tree build"):
        tree = MerkleTree.build(anon_addrs, anon_bals, height, device=device)
        root = tree.root()
        tree.write_root(os.path.join(build_dir, "merkle_root.json"))
        owned_idx = find_owned_indices(anon_addrs, [a.address for a in atts])
        proofs = {i: tree.prove(idx) for i, idx in enumerate(owned_idx)}
        tree.write_proofs(owned_idx, os.path.join(build_dir, "merkle_proofs.json"))
    del tree

    batches, bdirs = [], []
    for bi in range(bplan.num_batches):
        start, end = bplan.batch_range(bi)
        batches.append(atts[start:end])
        bdir = os.path.join(build_dir, f"batch_{bi}")
        os.makedirs(bdir, exist_ok=True)
        bdirs.append(bdir)

    resumed: List[str] = []
    cached_keys: List[str] = []

    def _setup(r1cs, name):
        # keys derive from the ceremony file when one is given (reference
        # g16_setup.sh:240-278), each setup's split going to benchmarks.txt
        def split(msg):
            _log(f"{name} {msg}")
            _bench(f"{name} {msg}")

        # under several ranks only rank 0 writes the shared cache
        return cached_setup(r1cs, zkey_cache, name, device, seed=setup_seed, hits=cached_keys,
                            ptau_path=ptau_path, contribute_entropy=contribute_entropy,
                            beacon_hash=beacon_hash, log=split,
                            save=not (dist.is_initialized() and dist.get_rank() > 0))

    def _resume_layer(bi: int, name: str) -> Optional[dict]:
        """A completed batch layer from its files (every stage restarts
        from files, the reference's design)."""
        if not resume:
            return None
        need = [os.path.join(bdirs[bi], f"{name}_sanitized_proof.json"),
                os.path.join(bdirs[bi], f"{name}_vkey.json")]
        if not all(os.path.exists(p) for p in need):
            return None
        with open(need[0]) as f:
            san = json.load(f)
        with open(need[1]) as f:
            vkj = json.load(f)
        _log(f"resume: {name} batch {bi} loaded from {bdirs[bi]}")
        resumed.append(f"{name} batch {bi}")
        return {"san": san, "vk_json": vkj}

    # -- layer 1 (batches of one size share one key: full_workflow.sh:303-323)
    san1s: List[Optional[dict]] = [None] * bplan.num_batches
    pk1_vk_jsons: List[Optional[dict]] = [None] * bplan.num_batches
    if mode in ("full", "recursive"):
        l1_done = {}
        for bi in range(bplan.num_batches):
            r = _resume_layer(bi, "layer_one")
            if r is not None:
                san1s[bi], pk1_vk_jsons[bi] = r["san"], r["vk_json"]
                l1_done[bi] = True
        l1_builds = []
        for bi, batch in enumerate(batches):
            if l1_done.get(bi):
                l1_builds.append(None)
                continue
            with Stage(f"layer1 build batch {bi}"):
                l1_inp_json = layer_one_input(batch)
                with open(os.path.join(bdirs[bi], "layer_one_input.json"), "w") as f:
                    json.dump(l1_inp_json, f)
                sigs = [LayerOneInput.from_json_entry(l1_inp_json, i) for i in range(len(batch))]
                c1 = layer_one_circuit(sigs)
                r1, w1 = c1.compile()
                constraints[f"layer_one batch {bi}"] = r1.n_constraints
                _bench(f"layer_one batch {bi}: {r1.n_constraints} constraints, "
                       f"{r1.n_wires} wires ({len(batch)} sigs)")
                l1_builds.append((r1, w1, c1.public_values))
        for group in _shape_groups(batches):
            group = [bi for bi in group if not l1_done.get(bi)]
            if not group:
                continue
            r1_0 = l1_builds[group[0]][0]
            nsig = len(batches[group[0]])
            with Stage(f"layer1 setup ({nsig} sigs)"):
                pk1 = _setup(r1_0, f"layer_one_{nsig}_sigs")
            with Stage(f"layer1 prove batches {group}"):
                proofs1 = _prove_many(pk1, r1_0, [l1_builds[bi][1] for bi in group],
                                      [f"l1-b{bi}" for bi in group], device)
            vk1 = groth16.VerifyingKey.from_json(pk1.vk_json)
            for proof1, bi in zip(proofs1, group):
                publics1 = l1_builds[bi][2]
                if not groth16.verify(vk1, proof1, publics1):
                    raise RuntimeError(f"layer-1 proof of batch {bi} does not verify")
                _write_proof(bdirs[bi], "layer_one", proof1, publics1, pk1.vk_json)
                san1s[bi] = sanitize(vk1, proof1, publics1)
                with open(os.path.join(bdirs[bi], "layer_one_sanitized_proof.json"), "w") as f:
                    json.dump(san1s[bi], f)
                pk1_vk_jsons[bi] = pk1.vk_json
            # release the layer-1 key before the next setup: only its
            # vk_json is needed downstream
            pk1 = None
        l1_builds = None

    # -- layer 2 (one key per batch shape) ---------------------------------
    batch_balance_sums: List[int] = [0] * bplan.num_batches
    l2_sanitized: List[Optional[dict]] = [None] * bplan.num_batches
    l2_vk_jsons: List[Optional[dict]] = [None] * bplan.num_batches
    l2_done = {}
    for bi in range(bplan.num_batches):
        r = _resume_layer(bi, "layer_two")
        if r is not None:
            l2_sanitized[bi], l2_vk_jsons[bi] = r["san"], r["vk_json"]
            # balance = pubInput[0] of the sanitized layer-2 proof
            # (reference input_prep_for_layer_three.ts:122)
            batch_balance_sums[bi] = int(r["san"]["pubInput"][0])
            l2_done[bi] = True
    l2_builds = []
    for bi, batch in enumerate(batches):
        if l2_done.get(bi):
            l2_builds.append(None)
            continue
        start, _ = bplan.batch_range(bi)
        with Stage(f"layer2 build batch {bi}"):
            batch_proofs = [proofs[start + j] for j in range(len(batch))]
            if mode in ("full", "recursive"):
                inp2 = _layer_two_input(batch, batch_proofs, root, height)
                if mode == "recursive":
                    inp2.proof = san1s[bi]
                with open(os.path.join(bdirs[bi], "layer_two_input.json"), "w") as f:
                    json.dump(_jsonable(inp2.__dict__), f)
                if mode == "recursive":
                    c2 = recursive_layer_two_circuit(inp2, pk1_vk_jsons[bi], height)
                else:
                    c2 = layer_two_circuit(inp2, tree_height=height)
            else:
                accounts = [
                    MembershipWitnessInput(address=a.address, balance=a.balance,
                                           path_elements=p.path_elements,
                                           path_indices=p.path_indices)
                    for a, p in zip(batch, batch_proofs)
                ]
                c2 = membership_sum_circuit(root, accounts, tree_levels=height - 1)
            r2, w2 = c2.compile()
            constraints[f"layer_two batch {bi}"] = r2.n_constraints
            _bench(f"layer_two batch {bi}: {r2.n_constraints} constraints, "
                   f"{r2.n_wires} wires ({len(batch)} sigs, height {height}, {mode})")
            l2_builds.append((r2, w2, c2.public_values))
    for group in _shape_groups(batches):
        group = [bi for bi in group if not l2_done.get(bi)]
        if not group:
            continue
        r2_0 = l2_builds[group[0]][0]
        nsig = len(batches[group[0]])
        with Stage(f"layer2 setup ({nsig} sigs)"):
            pk2 = _setup(r2_0, f"layer_two_{mode}_{nsig}_sigs_{height}_height")
        with Stage(f"layer2 prove batches {group}"):
            proofs2 = _prove_many(pk2, r2_0, [l2_builds[bi][1] for bi in group],
                                  [f"l2-b{bi}" for bi in group], device)
        vk2 = groth16.VerifyingKey.from_json(pk2.vk_json)
        for proof2, bi in zip(proofs2, group):
            publics2 = l2_builds[bi][2]
            if not groth16.verify(vk2, proof2, publics2):
                raise RuntimeError(f"layer-2 proof of batch {bi} does not verify")
            _write_proof(bdirs[bi], "layer_two", proof2, publics2, pk2.vk_json)
            l2_sanitized[bi] = sanitize(vk2, proof2, publics2)
            l2_vk_jsons[bi] = pk2.vk_json
            batch_balance_sums[bi] = publics2[0]
            with open(os.path.join(bdirs[bi], "layer_two_sanitized_proof.json"), "w") as f:
                json.dump(l2_sanitized[bi], f)
        pk2 = None  # release the layer-2 key
    l2_builds = None

    # -- layer 3: aggregation + Pedersen commitment -----------------------
    # full mode proves the in-circuit Pedersen commitment; accounting mode
    # proves the aggregation binding circuit and computes the commitment
    # registers on the host (the final check still holds them to the secrets)
    balance_sum = sum(batch_balance_sums)
    l3dir = os.path.join(build_dir, "layer_three")
    os.makedirs(l3dir, exist_ok=True)
    with Stage("layer3 build"):
        if mode in ("full", "recursive"):
            inner3 = []
            if mode == "recursive":
                from ..models.gadgets.pairing_gadget import PreparedVK

                inner3 = [(_prepared_vk_cached(vkj, PreparedVK), san)
                          for vkj, san in zip(l2_vk_jsons, l2_sanitized)]
            c3 = layer_three_circuit(batch_balance_sums, root, blinding_factor, inner=inner3)
            key3 = f"layer_three_{bplan.num_batches}_batches"
        else:
            from ..models.r1cs import Circuit

            c3 = Circuit()
            out = c3.public_output()
            c3.public(root)
            bal_sigs = [c3.var(b) for b in batch_balance_sums]
            total = bal_sigs[0]
            for b_sig in bal_sigs[1:]:
                total = total + b_sig
            c3.bind_output(out, total)
            key3 = f"layer_three_sum_{bplan.num_batches}_batches"
        r3, w3 = c3.compile()
        constraints["layer_three"] = r3.n_constraints
        _bench(f"layer_three: {r3.n_constraints} constraints, {r3.n_wires} "
               f"wires ({bplan.num_batches} batches, {mode})")
    with Stage("layer3 setup"):
        pk3 = _setup(r3, key3)
    with Stage("layer3 prove"):
        proof3 = prove(pk3, r3, w3, device, seed="l3", log=_log)
    vk3 = groth16.VerifyingKey.from_json(pk3.vk_json)
    if not groth16.verify(vk3, proof3, c3.public_values):
        raise RuntimeError("layer-3 proof does not verify")
    _write_proof(l3dir, "layer_three", proof3, c3.public_values, pk3.vk_json)
    pk3 = None
    if mode in ("full", "recursive"):
        l3_public = c3.public_values
    else:
        from ..utils.serde import to_limbs_85x3

        com = C.pedersen_commitment(balance_sum, blinding_factor)
        l3_public = [reg for ci in range(4) for reg in to_limbs_85x3(com[ci])] + [root]

    # -- final assertion (pedersen_commitment_checker) --------------------
    with Stage("pedersen check"):
        if not check_commitment(l3_public, balance_sum, blinding_factor) or l3_public[12] != root:
            raise RuntimeError("final Pedersen commitment check failed")
        with open(os.path.join(l3dir, "commitment.json"), "w") as f:
            json.dump([str(x) for x in l3_public], f)

    _flush_bench()
    _log(f"workflow OK: balance_sum={balance_sum} root={root}")
    return WorkflowResult(
        build_dir=build_dir, num_sigs=n, num_batches=bplan.num_batches, merkle_height=height,
        merkle_root=root, balance_sum=balance_sum, commitment=dechunk_commitment(l3_public),
        layer_three_public=l3_public, timings=timings, constraints=constraints,
        peaks=tracer.peaks, resumed=resumed, cached_keys=cached_keys,
    )


def _shape_groups(batches) -> List[List[int]]:
    """Batch indices grouped by batch size: same-size batches share one
    circuit shape and proving key; a remainder batch gets its own
    (reference full_workflow.sh:398-401)."""
    groups: Dict[int, List[int]] = {}
    for bi, b in enumerate(batches):
        groups.setdefault(len(b), []).append(bi)
    return list(groups.values())


def _prove_many(pk, r1cs, wits, seeds: List[str], device) -> List:
    """prove() for several same-shape witnesses: batched over a mesh
    "batch" axis when a process group of more than one rank is up (the
    reference's `seq 0 k-1 | parallel prove_layers_one_two`,
    full_workflow.sh:552; port of `zkpoa_tpu/pipeline/workflow.py:497`),
    else in turn on one device, each logging its phase ends. The seeds
    match between the two paths, so their proofs are byte-identical."""
    world = PM.world_size()
    if len(wits) > 1 and world > 1:
        mesh = PM.make_mesh(min(world, len(wits)), axis="batch", device=device)
        return prove_batched(pk, r1cs, wits, mesh, seeds=seeds, axis="batch")
    return [prove(pk, r1cs, w, device, seed=s, log=_log) for w, s in zip(wits, seeds)]


_PVK_CACHE: Dict[str, object] = {}


def _prepared_vk_cached(vk_json: dict, cls):
    """PreparedVK per distinct vkey (the zkey-cache analog for recursion)."""
    key = json.dumps(vk_json, sort_keys=True)
    if key not in _PVK_CACHE:
        _PVK_CACHE[key] = cls.from_vk(groth16.VerifyingKey.from_json(vk_json))
    return _PVK_CACHE[key]


def _write_proof(dirpath: str, name: str, proof, publics, vk_json) -> None:
    with open(os.path.join(dirpath, "proof.json"), "w") as f:
        json.dump(proof.to_json(), f)
    with open(os.path.join(dirpath, "public.json"), "w") as f:
        json.dump([str(x) for x in publics], f)
    with open(os.path.join(dirpath, f"{name}_vkey.json"), "w") as f:
        json.dump(vk_json, f)


def _layer_two_input(batch: List[AccountAttestation], batch_proofs, root: int,
                     height: int) -> LayerTwoInput:
    """input_prep_for_layer_two.ts equivalent: sponge hash + registers +
    merkle data from in-memory state."""
    sponge_regs: List[int] = []
    pubkeys = []
    for a in batch:
        x_regs = to_limbs_64x4(a.signature.pubkey[0])
        y_regs = to_limbs_64x4(a.signature.pubkey[1])
        sponge_regs.extend(x_regs)
        pubkeys.append([x_regs, y_regs])
    return LayerTwoInput(
        pubkey_x_coord_hash=poseidon_host.poseidon_sponge(sponge_regs),
        pubkeys=pubkeys,
        merkle_root=root,
        leaf_addresses=[a.address for a in batch],
        leaf_balances=[a.balance for a in batch],
        path_elements=[p.path_elements for p in batch_proofs],
        path_indices=[p.path_indices for p in batch_proofs],
    )


def recursive_layer_two_circuit(inp2: LayerTwoInput, vk1_json: dict, height: int):
    """Layer two of the recursive mode: the batch's membership and balance
    statement, with layer one's sanitized proof (`inp2.proof`) verified
    in-snark against layer one's verifying key."""
    from ..models.gadgets.pairing_gadget import PreparedVK

    if inp2.proof is None:
        raise ValueError("the recursive layer two needs layer one's sanitized proof")
    return layer_two_circuit(inp2, tree_height=height,
                             inner_vk=_prepared_vk_cached(vk1_json, PreparedVK))


def load_layer_two_input(bdir: str):
    """(LayerTwoInput, layer one's vkey JSON) of a batch directory that
    `run_workflow` wrote: layer_two_input.json with
    layer_one_sanitized_proof.json as its proof, and layer_one_vkey.json."""
    def load(name):
        with open(os.path.join(bdir, name)) as f:
            return json.load(f)

    ints = lambda x: [ints(y) for y in x] if isinstance(x, list) else int(x)  # noqa: E731
    d = {k: ints(v) for k, v in load("layer_two_input.json").items() if k != "proof"}
    inp2 = LayerTwoInput(**d, proof=load("layer_one_sanitized_proof.json"))
    return inp2, load("layer_one_vkey.json")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, int) and abs(obj) > 2**53:
        return str(obj)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Proof-of-assets workflow on PyTorch/CUDA (full_workflow.sh contract)")
    ap.add_argument("sigs", help="signatures.json (SignatureData[])")
    ap.add_argument("anon_set", help="anonymity set CSV (address,balance)")
    ap.add_argument("blinding_factor", type=lambda s: int(s, 0))
    ap.add_argument("-b", "--build-dir", default="build")
    ap.add_argument("-p", "--batch-size", type=int, default=2, help="ideal signatures per batch")
    ap.add_argument("-m", "--mode", choices=("accounting", "full", "recursive"),
                    default="accounting")
    ap.add_argument("-z", "--zkey-cache", default=None, help="directory of cached proving keys")
    ap.add_argument("-H", "--tree-height", type=int, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler chrome trace per stage under "
                         "<build>/logs/torch_trace")
    ap.add_argument("-r", "--resume", action="store_true",
                    help="reuse completed per-batch layer artifacts from a previous "
                         "(partial) run of the same build dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every setup, proof and tree (default cuda)")
    ap.add_argument("--ptau", default=None, metavar="PATH",
                    help="powers-of-tau ceremony file: layer keys derive from it instead of "
                         "the seeded dev SRS (reference g16_setup.sh ptau contract)")
    ap.add_argument("--contribute", default=None, metavar="ENTROPY",
                    help="phase-2 contribution entropy applied to every ptau-derived key "
                         "(requires --ptau)")
    ap.add_argument("--beacon", default=None, metavar="HASH",
                    help="phase-2 beacon randomizer applied after the contribution "
                         "(requires --ptau)")
    args = ap.parse_args(argv)
    if (args.contribute or args.beacon) and not args.ptau:
        ap.error("--contribute/--beacon require --ptau: phase-2 "
                 "randomization only applies to a ceremony-derived key "
                 "(without it the seeded dev SRS would be used silently)")
    started = not dist.is_initialized()
    world = PM.init_multihost(device=args.device)
    if world > 1 and args.resume:
        ap.error("--resume runs in one process: ranks resuming from different files would "
                 "prove different batches")
    rank, device = (dist.get_rank() if world > 1 else 0), args.device
    build_root = args.build_dir
    with contextlib.ExitStack() as stack:
        if world > 1 and torch.device(device).type == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
            if rank == 0:
                _build.lib()  # one build of the kernels; the other ranks load it
            dist.barrier()
        if rank > 0:
            # the same workflow, written where no one reads it: rank 0's build is the
            # output; the key cache is shared, and read only
            scratch = stack.enter_context(tempfile.TemporaryDirectory(prefix=f"zkpoa-rank{rank}-"))
            build_root = os.path.join(scratch, "build")
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        if world > 1 and started:
            stack.callback(dist.destroy_process_group)
        res = run_workflow(
            args.sigs, args.anon_set, args.blinding_factor,
            build_root=build_root, ideal_batch_size=args.batch_size, mode=args.mode,
            zkey_cache=args.zkey_cache, tree_height=args.tree_height, profile=args.profile,
            resume=args.resume, device=device, ptau_path=args.ptau,
            contribute_entropy=args.contribute, beacon_hash=args.beacon,
        )
    if rank:
        return 0
    _log(json.dumps({"build_dir": res.build_dir, "balance_sum": str(res.balance_sum),
                     "merkle_root": str(res.merkle_root),
                     "timings": {k: round(v, 2) for k, v in res.timings.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
