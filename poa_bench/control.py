"""The control of a cell, which has to come out as not correct:

    python3 -m poa_bench.control --workload <cell> --seeds <n> [<n> ...] --requests <k>

For each seed it makes the cell's set-up (the same pool of witnesses a run
makes), answers the first k requests of a window (the same witnesses and
(r, s)) with the plain reference put in the program's place with one
guarantee broken (`reference/judge.py` `control_answers`: each witness
value cut to its low 252 bits, as an MSM that skipped its top partial
window), and holds those answers against the exact reference with the
comparison a run uses. It prints each seed's numbers beside their limits
and exits 0 only when every seed's control comes out not correct. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from .reference.judge import LIMITS
from .run import PKG, ROOT, load_json, log


def control(name: str, seed: int, n_requests: int, device, pkg: str = PKG) -> dict:
    from .pool import randomness
    from .reference import judge as J

    cell = load_json(pkg, "workloads", f"{name}.json")
    config = load_json(pkg, "configs", f"{cell['config']}.json")
    circuit = importlib.import_module(f"{__package__}.circuits.{config['circuit']}")
    pool = circuit.build_pool(config, cell, seed, device)
    stmt, witnesses = pool.statement(), pool.witnesses
    requests = [(i % len(witnesses), *randomness(seed, i), None) for i in range(n_requests)]
    answers = J.control_answers(stmt, witnesses, pool.key_seed, device, requests)
    expected = J.Expected(stmt, witnesses, pool.key_seed, device)
    publics = [J.expected_publics(pool.kind, raw) for raw in pool.raws]
    parts = J.judge(expected, answers, witnesses, stmt.n_public, publics)
    return {"seed": seed, "correct": J.is_correct(parts), "parts": parts,
            "checks": J.compared(parts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m poa_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    load_json(ROOT, "BENCHMARK.json")
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in args.seeds:
        out = control(args.workload, seed, args.requests, "cuda")
        log(f"control seed {seed}: " + ", ".join(
            f"{k} {v} limit {LIMITS[k]}" for k, v in out["checks"].items()))
        print(json.dumps(out), flush=True)
        failed_all &= not out["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
