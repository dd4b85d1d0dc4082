"""Groth16 CLI of the port: setup, prove and verify for the layer circuits.

    python -m zkpoa_tpu_torch.prover setup  --layer one --input in.json --device cuda -Z keys/
    python -m zkpoa_tpu_torch.prover prove  --layer one --input in.json --device cuda -o out/
    python -m zkpoa_tpu_torch.prover verify vkey.json proof.json public.json

Port of `zkpoa_tpu/prover/__main__.py` with the same flags, plus `--device`
(where the key and the proving run live; nothing is chosen implicitly) and
`--repeat` (prove N times against the one key, to time cold and warm
proofs). The key is made by the development setup on the device each run:
the `.dpk` disk cache is not ported yet. `prove` self-verifies every proof
with the host pairing check and writes proof.json, public.json, the vkey
and stats.json (phase times and the constraint count).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(msg: str) -> None:
    print(f"[g16-torch] {msg}", flush=True)


def _build_circuit(layer: str, d: dict, recursive: bool):
    """Circuit + name from a reference-shaped input JSON (same circuits as
    `zkpoa_tpu/prover/__main__.py:36` `_build_circuit`; the circuit
    frontend is shared)."""
    from zkpoa_tpu.models.layers import (
        LayerOneInput,
        LayerTwoInput,
        layer_one_circuit,
        layer_three_circuit,
        layer_two_circuit,
    )

    if layer == "one":
        n = len(d["r"])
        sigs = [LayerOneInput.from_json_entry(d, i) for i in range(n)]
        return layer_one_circuit(sigs), f"layer_one_{n}_sigs"
    if layer == "two":
        inp = LayerTwoInput.from_json(d)
        height = len(d["path_elements"][0]) + 1
        inner_vk, suffix = None, ""
        if recursive:
            from zkpoa_tpu.models.gadgets.pairing_gadget import PreparedVK

            inner_vk, suffix = PreparedVK.from_sanitized(d), "_recursive"
        c = layer_two_circuit(inp, tree_height=height, inner_vk=inner_vk)
        return c, f"layer_two_full{suffix}_{len(d['pubkey'])}_sigs_{height}_height"
    if layer == "three":
        balances = [int(x) for x in d["balances"]]
        inner, suffix = [], ""
        if recursive:
            from zkpoa_tpu.models.gadgets.pairing_gadget import PreparedVK

            shared = {k: d[k] for k in ("gamma2", "delta2", "negalfa1xbeta2", "IC")}
            pvk = PreparedVK.from_sanitized(shared)
            for b in range(len(balances)):
                inner.append((pvk, {"negpa": d["negpa"][b], "pb": d["pb"][b], "pc": d["pc"][b]}))
            suffix = "_recursive"
        c = layer_three_circuit(balances, int(d["merkle_root"]),
                                int(d["ped_com_blinding_factor"]), inner=inner)
        return c, f"layer_three{suffix}_{len(balances)}_batches"
    raise SystemExit(f"unknown layer {layer!r}")


def _build(args):
    with open(args.input) as f:
        d = json.load(f)
    t0 = time.time()
    circuit, name = _build_circuit(args.layer, d, args.recursive)
    r1cs, witness = circuit.compile()
    build_s = time.time() - t0
    _log(f"{name}: {r1cs.n_constraints} constraints, {r1cs.n_wires} wires, "
         f"witness ready ({build_s:.2f}s)")
    return circuit, name, r1cs, witness, build_s


def _setup(args, r1cs):
    from .prove import _sync
    from .setup import setup_device

    t0 = time.time()
    pk = setup_device(r1cs, args.device, seed=args.seed, log=_log)
    _sync(args.device)
    setup_s = time.time() - t0
    _log(f"setup_device: domain 2^{pk.domain_size.bit_length() - 1} ({setup_s:.2f}s)")
    return pk, setup_s


def _cmd_setup(args) -> int:
    _circuit, name, r1cs, _witness, _ = _build(args)
    pk, _ = _setup(args, r1cs)
    if args.zkey_dir:
        os.makedirs(args.zkey_dir, exist_ok=True)
        with open(os.path.join(args.zkey_dir, f"{name}_vkey.json"), "w") as f:
            json.dump(pk.vk_json, f)
        _log(f"vkey -> {name}_vkey.json")
    return 0


def _cmd_prove(args) -> int:
    from zkpoa_tpu.prover import groth16

    from .prove import _sync, prove

    circuit, name, r1cs, witness, build_s = _build(args)
    pk, setup_s = _setup(args, r1cs)
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    stats = {"name": name, "constraints": r1cs.n_constraints, "wires": r1cs.n_wires,
             "domain": pk.domain_size, "build_s": build_s, "setup_s": setup_s,
             "prove_s": [], "verify_s": []}
    proof = None
    for i in range(args.repeat):
        t0 = time.time()
        proof = prove(pk, r1cs, witness, args.device, seed=args.proof_seed, log=_log)
        _sync(args.device)
        stats["prove_s"].append(time.time() - t0)
        t0 = time.time()
        assert groth16.verify(vk, proof, circuit.public_values), "self-verify failed"
        stats["verify_s"].append(time.time() - t0)
        _log(f"proof {i + 1}/{args.repeat} in {stats['prove_s'][-1]:.2f}s, verified "
             f"({stats['verify_s'][-1]:.2f}s)")
    os.makedirs(args.out_dir, exist_ok=True)
    out = {
        "proof.json": proof.to_json(),
        "public.json": [str(x) for x in circuit.public_values],
        f"layer_{args.layer}_vkey.json": pk.vk_json,
        "stats.json": stats,
    }
    for fname, obj in out.items():
        with open(os.path.join(args.out_dir, fname), "w") as f:
            json.dump(obj, f)
    _log(f"wrote proof.json/public.json to {args.out_dir}")
    return 0


def _cmd_verify(args) -> int:
    from zkpoa_tpu.prover.groth16 import verify_files

    ok = verify_files(args.vkey, args.proof, args.public)
    print("OK" if ok else "INVALID")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkpoa_tpu_torch.prover",
                                 description="Groth16 toolchain on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd, fn in (("setup", _cmd_setup), ("prove", _cmd_prove)):
        p = sub.add_parser(cmd)
        p.add_argument("--layer", choices=("one", "two", "three"), required=True)
        p.add_argument("--input", required=True, help="reference-shaped layer input JSON")
        p.add_argument("--device", required=True, help="torch device, e.g. cuda or cpu")
        p.add_argument("--seed", default="zkpoa-test-srs", help="dev-setup seed")
        p.add_argument("--recursive", action="store_true",
                       help="verify the embedded lower-layer proof in-snark")
        if cmd == "setup":
            p.add_argument("-Z", "--zkey-dir", default=None, help="directory for the vkey")
        else:
            p.add_argument("-o", "--out-dir", required=True)
            p.add_argument("--proof-seed", default="zkpoa-proof")
            p.add_argument("--repeat", type=int, default=1,
                           help="prove this many times against the one key")
        p.set_defaults(fn=fn)
    p = sub.add_parser("verify")
    p.add_argument("vkey")
    p.add_argument("proof")
    p.add_argument("public")
    p.set_defaults(fn=_cmd_verify)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
