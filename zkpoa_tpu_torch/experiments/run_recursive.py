"""The recursive three-layer chain of the port, end to end on the card.

Port of `experiments/run_recursive.py`: the full protocol with in-snark
proof recursion at the reference's smallest golden scale, one signature a
batch and a tree of height 5. Layer one proves each batch's ECDSA*
signatures; layer two verifies that proof IN-SNARK (the residue-witness
pairing verifier, about 7M constraints, a 2^23 domain) beside the Keccak
address, Merkle inclusion and balance sum; layer three verifies every
layer-two proof in-snark and proves the Pedersen commitment (15,212,239
constraints at 2 signatures, a 2^24 domain).

    python -m zkpoa_tpu_torch.experiments.run_recursive [build_root] [n_sigs]
        [--device cuda|cpu] [--no-resume] [--check-only]

Defaults: `build/torch_recursive/run<n_sigs>` (gitignored), 2 signatures,
`cuda`, resume on. The inputs come from the port's `write_fixtures(n_sigs,
..., extra=13 - n_sigs)`, the recorded runs' own call. Keys are cached in
`<build_root>/zkeys`; with resume, every batch layer whose sanitized proof
and verifying key are already on disk is loaded instead of proved again (so
a chain cut between layers goes on from the small JSON files alone). A run
on a root that an earlier run filled therefore times only what it did:
`resumed` lists the batch layers it loaded, `cached_keys` the proving keys
it took from the cache, and `whole_chain` is true only when both are empty,
so that `wall_s` and `stage_seconds` are those of the whole chain.

It writes `<build_root>/RECURSIVE_RUN.json` with the recorded run's
fields (`batches`, `stage_seconds`, `constraints`, `layer3_verify`,
`pedersen_check`, `balance_sum`, `complete_chain_ok`) and beside them
`wall_s`, the peak host RSS, the peak device memory, each stage's peaks
(`stage_peaks`, the process's peaks at the stage's end), the device and,
under `recorded_check`, the comparison with the recorded run of the same
shape (`RECORDED`): its Merkle root, balance sum, each batch's layer-two
public values and the 13 layer-three public values. `complete_chain_ok` is
true only when every proof verifies under the host verifier, the
commitment check holds and every recorded value is equal.
`--check-only` writes nothing new: it holds an existing run's output
directory against the recorded one and prints the comparison.

The recorded runs `build/recursive_run*/` are the reference: the runner
refuses to write under them.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BLIND = 0xB11DD1E5
TREE_HEIGHT = 5
# the recorded run of each shape (the JAX package's, on a TPU): its build dir
RECORDED = {
    2: os.path.join(REPO, "build", "recursive_run2", "2_sigs_2_batches_5_height"),
    1: os.path.join(REPO, "build", "recursive_run", "1_sigs_1_batches_5_height"),
}


def _log(msg: str) -> None:
    print(f"[run_recursive] {msg}", flush=True)


def refuse_recorded(path: str) -> None:
    """Raise if `path` lies under a recorded run, `build/recursive_run*/`."""
    build = os.path.realpath(os.path.join(REPO, "build"))
    rel = os.path.relpath(os.path.realpath(path), build)
    top = rel.split(os.sep)[0]
    if not rel.startswith("..") and top.startswith("recursive_run"):
        raise ValueError(f"{path} lies under the recorded run build/{top}/: "
                         f"choose another build root")


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def check_against_recorded(out_dir: str, recorded_dir: str) -> Dict[str, object]:
    """Hold a run's output directory against the recorded run's: the Merkle
    root, the balance sum, each batch's layer-two public values and the
    layer-three public values. Returns {item: bool} for every item the
    recorded run holds, and "ok", true when each of them is equal."""
    out: Dict[str, object] = {}
    same = lambda *p: _load(out_dir, *p) == _load(recorded_dir, *p)  # noqa: E731
    have = lambda *p: os.path.exists(os.path.join(recorded_dir, *p))  # noqa: E731
    mine = lambda *p: os.path.exists(os.path.join(out_dir, *p))  # noqa: E731
    out["merkle_root"] = mine("merkle_root.json") and same("merkle_root.json")
    batches = sorted(d for d in os.listdir(recorded_dir) if d.startswith("batch_"))
    sums = {}
    for name, where in (("recorded", recorded_dir), ("run", out_dir)):
        try:
            sums[name] = sum(int(_load(where, b, "public.json")[0]) for b in batches)
        except (OSError, ValueError):
            sums[name] = None
    out["balance_sum"] = sums["run"] is not None and sums["run"] == sums["recorded"]
    for b in batches:
        out[f"{b}_public"] = mine(b, "public.json") and same(b, "public.json")
    if have("layer_three", "public.json"):
        out["layer_three_public"] = (mine("layer_three", "public.json")
                                     and same("layer_three", "public.json"))
    out["ok"] = all(bool(v) for v in out.values())
    return out


def verify_outputs(out_dir: str, n_batches: int) -> Dict[str, object]:
    """The host verifier on every proof the run left on disk: each batch's
    layer-two proof and the layer-three proof (a batch's layer-one proof was
    checked by the workflow before its sanitized form went in-snark)."""
    from ..prover import groth16

    def ok(d, name):
        d = os.path.join(out_dir, d)
        files = [os.path.join(d, f"{name}_vkey.json"), os.path.join(d, "proof.json"),
                 os.path.join(d, "public.json")]
        return all(os.path.exists(p) for p in files) and groth16.verify_files(*files)

    batches = [{"batch": b,
                "layer1_sanitized": os.path.exists(os.path.join(
                    out_dir, f"batch_{b}", "layer_one_sanitized_proof.json")),
                "layer2_verify": ok(f"batch_{b}", "layer_two")}
               for b in range(n_batches)]
    return {"batches": batches, "layer3_verify": ok("layer_three", "layer_three")}


def run(build_root: str, n_sigs: int, device: str = "cuda", resume: bool = True,
        recorded: Optional[str] = None) -> dict:
    """Fixtures, the recursive workflow, the host checks; returns (and
    writes) the RECURSIVE_RUN.json record."""
    import torch

    from ..pipeline import fixtures
    from ..pipeline.workflow import run_workflow

    refuse_recorded(build_root)
    os.makedirs(build_root, exist_ok=True)
    sigs = os.path.join(build_root, "sigs.json")
    anon = os.path.join(build_root, "anon.csv")
    fixtures.write_fixtures(n_sigs, sigs, anon, extra=13 - n_sigs)
    t0 = time.time()
    res = run_workflow(sigs, anon, blinding_factor=BLIND, build_root=build_root,
                       ideal_batch_size=1, mode="recursive",
                       zkey_cache=os.path.join(build_root, "zkeys"), tree_height=TREE_HEIGHT,
                       resume=resume, device=device)
    wall = time.time() - t0
    cuda = torch.device(device).type == "cuda"
    checks = verify_outputs(res.build_dir, res.num_batches)
    rec = check_against_recorded(res.build_dir, recorded) if recorded else None
    proofs_ok = checks["layer3_verify"] and all(b["layer1_sanitized"] and b["layer2_verify"]
                                                for b in checks["batches"])
    out = {
        "build_dir": os.path.relpath(res.build_dir, REPO),
        "mode": "recursive",
        "config": f"{n_sigs}_sigs_{res.num_batches}_batches_{TREE_HEIGHT}_height",
        **checks,
        "stage_seconds": {k: round(v, 2) for k, v in res.timings.items()},
        "constraints": res.constraints,
        # the workflow raises unless the final commitment check holds
        "pedersen_check": True,
        "balance_sum": str(res.balance_sum),
        "complete_chain_ok": bool(proofs_ok and (rec is None or rec["ok"])),
        "recorded_check": rec,
        "recorded_dir": os.path.relpath(recorded, REPO) if recorded else None,
        "wall_s": round(wall, 1),
        "peak_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
        "peak_device_gb": (round(torch.cuda.max_memory_allocated() / 2**30, 2) if cuda
                           else None),
        "stage_peaks": res.peaks,
        "device": torch.cuda.get_device_name(0) if cuda else device,
        "resume": resume,
        "resumed": res.resumed,
        "cached_keys": res.cached_keys,
        "whole_chain": not (res.resumed or res.cached_keys),
    }
    with open(os.path.join(build_root, "RECURSIVE_RUN.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="The recursive three-layer chain on the card")
    ap.add_argument("build_root", nargs="?", default=None,
                    help="output root (default build/torch_recursive/run<n_sigs>)")
    ap.add_argument("n_sigs", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--no-resume", action="store_true",
                    help="prove every batch layer again instead of loading finished ones")
    ap.add_argument("--check-only", action="store_true",
                    help="compare an existing run's outputs with the recorded run and exit")
    args = ap.parse_args(argv)
    root = args.build_root or os.path.join(REPO, "build", "torch_recursive", f"run{args.n_sigs}")
    recorded = RECORDED.get(args.n_sigs)
    if args.check_only:
        if recorded is None:
            ap.error(f"no recorded run of {args.n_sigs} signatures to check against")
        out_dir = os.path.join(root, f"{args.n_sigs}_sigs_{args.n_sigs}_batches_"
                                     f"{TREE_HEIGHT}_height")
        rec = check_against_recorded(out_dir, recorded)
        print(json.dumps(rec), flush=True)
        return 0 if rec["ok"] else 1
    out = run(root, args.n_sigs, device=args.device, resume=not args.no_resume,
              recorded=recorded)
    print(json.dumps(out), flush=True)
    if not out["complete_chain_ok"]:
        _log("the chain is not complete: see RECURSIVE_RUN.json")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
