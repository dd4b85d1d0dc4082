"""Groth16 CLI of the port: setup, prove and verify for the layer circuits.

    python -m zkpoa_tpu_torch.prover setup  --layer one --input in.json --device cuda -Z keys/
    python -m zkpoa_tpu_torch.prover prove  --layer one --input in.json --device cuda -o out/
    python -m zkpoa_tpu_torch.prover verify vkey.json proof.json public.json
    python -m zkpoa_tpu_torch.prover export --layer one --input in.json -o out/ [--zkey]
    python -m zkpoa_tpu_torch.prover prove-zkey --zkey k.zkey --wtns w.wtns -o out/
    python -m zkpoa_tpu_torch.prover sanitize vkey.json proof.json public.json -o s.json

Port of `zkpoa_tpu/prover/__main__.py` with the same flags, plus `--device`
(where the key and the proving run live: `cuda` unless `cpu` is asked for)
and `--repeat` (prove N times against the one key, to time cold and warm
proofs). `setup` and `prove` make the key by the development setup on the
device each run. `export` writes the iden3 artifacts snarkjs and
rapidsnark read (.r1cs, .wtns and, with `--zkey`, the dev key's .zkey);
`prove-zkey` proves from a .zkey and a .wtns alone (the rapidsnark
prover's contract) and self-verifies.
Circuits come from the port's own frontend (`models/layers.py`). `prove`
self-verifies every proof with the host pairing check and writes
proof.json, public.json, the vkey and stats.json (phase times and the
constraint count).
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
    `zkpoa_tpu/prover/__main__.py:36` `_build_circuit`)."""
    from ..models.layers import (
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
            from ..models.gadgets.pairing_gadget import PreparedVK

            inner_vk, suffix = PreparedVK.from_sanitized(d), "_recursive"
        c = layer_two_circuit(inp, tree_height=height, inner_vk=inner_vk)
        return c, f"layer_two_full{suffix}_{len(d['pubkey'])}_sigs_{height}_height"
    if layer == "three":
        balances = [int(x) for x in d["balances"]]
        inner, suffix = [], ""
        if recursive:
            from ..models.gadgets.pairing_gadget import PreparedVK

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
    from . import groth16

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


def _cmd_export(args) -> int:
    """Emit .r1cs, .wtns and, with --zkey, the .zkey of the (cached) dev
    key for a layer input (port of `__main__.py:133` `_cmd_export`)."""
    from ..utils import binfmt
    from ..utils.binfmt_torch import write_zkey_device
    from .cache import cached_setup

    _circuit, name, r1cs, witness, _ = _build(args)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.join(args.out_dir, name)
    binfmt.write_r1cs(base + ".r1cs", r1cs)
    binfmt.write_wtns(base + ".wtns", witness)
    _log(f"export: {base}.r1cs ({r1cs.n_constraints} constraints), .wtns")
    if args.zkey:
        pk = cached_setup(r1cs, args.zkey_dir, name, args.device, seed=args.seed)
        t0 = time.time()
        write_zkey_device(base + ".zkey", pk, r1cs)
        _log(f"export: {base}.zkey ({time.time() - t0:.2f}s)")
    return 0


def _cmd_prove_zkey(args) -> int:
    """Prove from foreign artifacts only, a .zkey and a .wtns (the
    rapidsnark prover CLI contract, ref scripts/g16_prove.sh:246-252;
    port of `__main__.py:155` `_cmd_prove_zkey`)."""
    from ..utils import binfmt
    from ..utils.binfmt_torch import read_zkey_device
    from . import groth16
    from .prove import _sync, prove

    t0 = time.time()
    pk, r1cs = read_zkey_device(args.zkey, args.device)
    witness = binfmt.read_wtns(args.wtns)
    _sync(args.device)
    _log(f"prove-zkey: zkey {pk.n_vars} vars / domain {pk.domain_size} loaded "
         f"({time.time() - t0:.2f}s)")
    t0 = time.time()
    proof = prove(pk, r1cs, witness, args.device, seed=args.proof_seed, log=_log)
    _sync(args.device)
    _log(f"prove-zkey: proof in {time.time() - t0:.2f}s")
    publics = witness[1 : pk.n_public + 1]
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    if not groth16.verify(vk, proof, publics):
        raise RuntimeError("self-verify failed")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "proof.json"), "w") as f:
        json.dump(proof.to_json(), f)
    with open(os.path.join(args.out_dir, "public.json"), "w") as f:
        json.dump([str(x) for x in publics], f)
    _log(f"prove-zkey: wrote proof.json/public.json to {args.out_dir}")
    return 0


def _cmd_sanitize(args) -> int:
    from ..pipeline.sanitize import sanitize_files

    sanitize_files(args.vkey, args.proof, args.public, args.out)
    print(f"sanitized -> {args.out}")
    return 0


def _cmd_verify(args) -> int:
    from .groth16 import verify_files

    ok = verify_files(args.vkey, args.proof, args.public)
    print("OK" if ok else "INVALID")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkpoa_tpu_torch.prover",
                                 description="Groth16 toolchain on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd, fn in (("setup", _cmd_setup), ("prove", _cmd_prove), ("export", _cmd_export)):
        p = sub.add_parser(cmd)
        p.add_argument("--layer", choices=("one", "two", "three"), required=True)
        p.add_argument("--input", required=True, help="reference-shaped layer input JSON")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu for small circuits)")
        p.add_argument("--seed", default="zkpoa-test-srs", help="dev-setup seed")
        p.add_argument("--recursive", action="store_true",
                       help="verify the embedded lower-layer proof in-snark")
        if cmd == "setup":
            p.add_argument("-Z", "--zkey-dir", default=None, help="directory for the vkey")
        elif cmd == "export":
            p.add_argument("-Z", "--zkey-dir", default=None, help="proving-key cache dir")
            p.add_argument("-o", "--out-dir", required=True)
            p.add_argument("--zkey", action="store_true", help="also run setup and emit a .zkey")
        else:
            p.add_argument("-o", "--out-dir", required=True)
            p.add_argument("--proof-seed", default="zkpoa-proof")
            p.add_argument("--repeat", type=int, default=1,
                           help="prove this many times against the one key")
        p.set_defaults(fn=fn)
    p = sub.add_parser("prove-zkey", help="prove from a .zkey + .wtns "
                       "(rapidsnark prover CLI contract)")
    p.add_argument("--zkey", required=True)
    p.add_argument("--wtns", required=True)
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--proof-seed", default="zkpoa-proof")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small circuits)")
    p.set_defaults(fn=_cmd_prove_zkey)
    p = sub.add_parser("verify")
    p.add_argument("vkey")
    p.add_argument("proof")
    p.add_argument("public")
    p.set_defaults(fn=_cmd_verify)
    p = sub.add_parser("sanitize")
    p.add_argument("vkey")
    p.add_argument("proof")
    p.add_argument("public")
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=_cmd_sanitize)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
