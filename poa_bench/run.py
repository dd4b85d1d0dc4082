"""The benchmark's one command, run from the root of a checkout:

    python3 -m poa_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run finds everything by name: the cell's file `workloads/<cell>.json`,
its configuration `configs/<config>.json`, the circuit kind
`circuits/<kind>.py` that builds its pool through the program, the traffic
kind `traffic/<kind>.py`, and for each metric that `BENCHMARK.json`
assigns to the cell its file `specs/<metric>.json` and reader
`metrics/<reader>.py`. It builds or loads the program's kernels (the
program caches them in `build/torch_kernels/` of the checkout), makes its
inputs from the seed, sets up and warms up, then either drives the cell's
traffic for `--seconds` (`--trace 0`: the end-to-end metrics) or serves
the cell's fixed number of requests under the profiler (`--trace 1`: the
per-layer metrics). Then it frees the program's state, holds every answer
against the plain reference (`reference/judge.py`), prints each number
compared beside its limit on standard error, and prints one JSON line on
standard output. Without a card it fails; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "zkpoa_tpu")


def log(msg: str) -> None:
    print(f"[poa_bench {time.perf_counter() - T_PROCESS:8.2f}s] {msg}", file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` list that the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (zkpoa_tpu_torch is not zkpoa_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def program_prove(device):
    """The program's prove entry as the traffic calls it."""
    from zkpoa_tpu_torch.prover.prove import prove

    def call(key, r1cs, witness, r, s, log=None):
        p = prove(key, r1cs, witness, device, r=r, s=s, log=log)
        return (p.pi_a, p.pi_b, p.pi_c)
    return call


def window(ctx, serve, seconds: float) -> list:
    """Whole requests back to back until `seconds` have passed since the
    first one started; a request that raises ends the window."""
    from .pool import Request, randomness

    requests, i, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        try:
            requests.append(serve(ctx, i))
        except Exception:  # the run reports it as a missing answer
            traceback.print_exc()
            requests.append(Request(i, i % len(ctx.pool.witnesses), *randomness(ctx.seed, i),
                                    t_start=time.perf_counter(), error="raised"))
            break
        i += 1
    return requests


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_PROCESS, prove=None, pkg: str = PKG) -> dict:
    """One run of a cell; `prove` and `pkg` (the directory of the data
    files) let a test put a broken prover or a toy cell in place."""
    import torch

    from . import devtrace
    from . import peaks as peaks_mod
    from .pool import Ctx, RunData
    from .reference import judge as J

    entry = next(w for w in bench["workloads"] if w["name"] == name)
    cell = load_json(pkg, "workloads", f"{name}.json")
    config = load_json(pkg, "configs", f"{cell['config']}.json")
    circuit = importlib.import_module(f"{__package__}.circuits.{config['circuit']}")
    traffic = importlib.import_module(f"{__package__}.traffic.{cell['traffic']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    log(f"cell {name}, seed {seed}: building the pool")
    pool = circuit.build_pool(config, cell, seed, device)
    log(f"pool: {len(pool.witnesses)} witnesses, {pool.r1cs.n_constraints} constraints, "
        f"{pool.r1cs.n_wires} wires")
    ctx = Ctx(config, seed, pool, circuit, prove or program_prove(device))
    for k in range(cell["warmup"]):
        traffic.serve(ctx, -(k + 1))
    setup_s = time.perf_counter() - t_start
    log(f"set-up done: {setup_s:.3f} s")

    tr, card = None, None
    if trace:
        requests, tr = devtrace.traced(ctx, traffic.serve, range(cell["traced_requests"]))
        card = peaks_mod.read(torch.device(device).index or 0) if cuda else None
    else:
        requests = window(ctx, traffic.serve, seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"{len(requests)} requests served")

    data = RunData(requests, setup_s, ctx, tr, card)
    metrics = {}
    for m in cell_metrics(bench, name, "per_layer" if trace else "end_to_end"):
        spec = load_json(pkg, "specs", f"{m['name']}.json")
        value = importlib.import_module(f"{__package__}.metrics.{spec['reader']}").read(spec, data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": len(requests), "failed": 0, "metrics": metrics,
              "device": dev}
    if tr is not None:
        lo, hi = tr.window
        dev["busy_s"] = devtrace.busy_us(devtrace.clip(tr.device, lo, hi)) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = devtrace.breakdown(tr)
    if card is not None:
        result["peaks"] = card

    # the program's state goes before the reference runs on the card
    stmt, witnesses, raws, kind = pool.statement(), pool.witnesses, pool.raws, pool.kind
    key_seed = pool.key_seed
    answers = [(r.wi, r.r, r.s, r.proof) for r in requests]
    del ctx, data, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = J.Expected(stmt, witnesses, key_seed, device)
    publics, memo = [], {}
    for raw in raws:
        key = json.dumps(raw, sort_keys=True)
        if key not in memo:
            memo[key] = J.expected_publics(kind, raw)
        publics.append(memo[key])
    parts = J.judge(expected, answers, witnesses, stmt.n_public, publics)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s; "
        + ", ".join(f"{k} {v}" for k, v in parts.items()))
    result["correct"] = J.is_correct(parts)
    result["failed"] = parts["proofs_wrong"] + parts["answers_missing"]
    result["checks"] = {k: {"value": v, "limit": J.LIMITS[k]}
                        for k, v in J.compared(parts).items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m poa_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
