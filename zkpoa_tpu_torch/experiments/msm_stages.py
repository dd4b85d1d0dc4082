"""Stage-level G1 MSM harness and gather-kernel race (E1-E3) on the card.

Port of the JAX package's `experiments/msm_stages.py`: each stage of a G1
MSM over 2^log_n points is timed on its own, and ways of gathering point
rows are raced against each other.

    python -m zkpoa_tpu_torch.experiments.msm_stages [log_n] [c] [--device cuda|cpu]
        [--piece K] [--out PATH]

Defaults: log_n 20 and c 13 (the JAX harness's), device cuda, K the plan's
default piece size (`ops/msm.py` PIECE: bucket entries per B5 thread), out
build/torch_experiments/msm_stages.json (never the JAX harness's
experiments/MSM_STAGES.json). On the card a stage's `warm_s` is its first
call on the host clock with a synchronize, and `best_s` the least CUDA-event
time of REPS more calls; gathers add `mrows_s`, and the kernels E1-E3 the
`index_select` time at the same shape (`library_best_s`). `--device cpu`
runs the plain version of every kernel, one call each (best_s = warm_s);
its times are the CPU's, not a device's. The last line of stdout is the JSON written.

Stages, by the JAX harness's names where it has the stage:
  digits          `recode` (signed c-bit digits)
  plan(sort)      `plan_msm(..., split_heavy=False)`: recode, one sort per
                  window, bucket starts (the JAX `_plan_dev` has no heavy
                  split either)
  g_take_rows     index_select of one coordinate, [N, 8] int32 (32 B rows)
  g_take_xy_rows  index_select of x|y rows, [N, 16]
  g_take_limbmaj  index_select along dim 1 of the limb-major [8, N]
  g_take_pad128   index_select of [N, 128] rows (x|y repeated 8 times), at
                  N / 8 rows
  g_take_sorted   g_take_rows with the indices sorted
  g_vmem_pallas   E1 `gather_smem_rows`: table [2^11, 16], 2^15 rows
  g_vmem_take     E2 `gather_vec`: table [2^11, 16], 2^13 rows (the shape
                  E2 ran at while it staged the table)
  g_vmem_take_2p13  E2 at the JAX harness's shape: [2^13, 16], 2^13 rows
  g_vmem_take_2p20  E2: [2^13, 16], 2^20 rows (64 MiB written)
  g_dma_pallas    E3 `gather_async` at the TPU's shape: [2^18, 128], 2^14 rows
  g_dma_msm       E3 at the MSM's shape: the x|y table [N, 16], N rows in
                  B5's visit order
  full_group      one B5 call (`accumulate`: the piece and combine
                  kernels) over the whole plan; `pieces` (of at most
                  `piece` entries), `max_pieces` (the most of any bucket),
                  `combine_levels` and `combine_depth` (the longest chain
                  of full adds through them) beside `occupancy` (the
                  longest bucket run)
  reduce          B7 (`reduce`) of those buckets
  msm             the whole MSM (`msm`: plan, B5, B7, Horner), checked exactly
The library gathers (torch.index_select stands for jnp.take) gather the
point visits of one window of B5: window 0's bucket-sorted order, N rows.
The TPU's rows per accumulation group (m_group = RG_ROUNDS x lanes) and
its group count have no counterpart: B5 walks every bucket's run in one
launch. Neither have `g_take_tr` and `kernel_64r`, which time the TPU's
[rounds, limbs, lanes] layout and its kernel on a pre-gathered stream: B5
reads its points by index inside the kernel. A table of E1-E3 is cut to N
rows where N is smaller than its shape.

Points are real, not random limbs: P_i = g_i G for random 63-bit g_i, made
by kernel B8, with random scalars s_i < r (numpy seed 0), so the MSM must
equal (sum s_i g_i mod r) G exactly; a wrong total exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import _build, host
from ..fields import bn254
from ..ops import gather as G
from ..ops import msm as M
from ..ops.curve import BN254_G1, fixed_base_mul_batch, jac_to_affine_mont
from ..ops.fp2 import g2_jac_to_affine_mont
from ..prover.setup import DeviceG1Points, DeviceG2Points

DEFAULT_OUT = os.path.join(_build.REPO_ROOT, "build", "torch_experiments", "msm_stages.json")
REPS = {"cuda": 10, "cpu": 0}
SEED = 0

# stage -> (wrapper, table rows, row words, rows gathered); None: the MSM's N
GATHER_KERNELS = {
    "g_vmem_pallas": (G.gather_smem_rows, 1 << 11, 16, 1 << 15),
    "g_vmem_take": (G.gather_vec, 1 << 11, 16, 1 << 13),
    "g_dma_pallas": (G.gather_async, 1 << 18, 128, 1 << 14),
    "g_dma_msm": (G.gather_async, None, 16, None),
    # last, so that adding them left the indices of the stages above unchanged
    "g_vmem_take_2p13": (G.gather_vec, 1 << 13, 16, 1 << 13),
    "g_vmem_take_2p20": (G.gather_vec, 1 << 13, 16, 1 << 20),
}
NO_COUNTERPART = {
    "g_take_tr": "the TPU's [rounds, limbs, lanes] lane layout; B5 reads points by index",
    "kernel_64r": "the TPU kernel on a pre-gathered 64-round stream; B5 gathers in-kernel",
}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def host_inputs(log_n: int, seed: int = SEED):
    """(g_i, s_i): 2^log_n random 63-bit multipliers of G and scalars < r."""
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    gens = [int(x) for x in rng.integers(1, 2**63, size=n, dtype=np.uint64)]
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    return gens, scal


def fixed_base_points(curve, base, host_add, gens, device):
    """Affine device table of g_i * base for 63-bit g_i (B8 on the card)."""
    sc = torch.from_numpy(host.scalars_to_limbs_fast(gens)).to(device)
    jac = fixed_base_mul_batch(curve, base, host_add, sc, 64)
    if curve.group == 1:
        return DeviceG1Points(*jac_to_affine_mont(curve.field, jac))
    return DeviceG2Points(*g2_jac_to_affine_mont(jac))


def gather_cases(xy: torch.Tensor, visit: torch.Tensor, rng):
    """(stage, wrapper, tab, idx) of E1-E3 at the harness's shapes, from the
    x|y point rows xy [N, 16] and one window's visit order [N] int32."""
    n = xy.shape[0]
    out = []
    for stage, (fn, t, w, m) in GATHER_KERNELS.items():
        if t is None:
            out.append((stage, fn, xy, visit))
            continue
        t = min(t, n)
        tab = xy[:t].repeat(1, w // xy.shape[1])
        idx = torch.from_numpy(rng.integers(0, t, size=m, dtype=np.int32)).to(xy.device)
        out.append((stage, fn, tab, idx))
    return out


class Timer:
    """warm_s: first call, host clock with a synchronize; best_s: least of
    `reps` more calls (CUDA events on the card, the host clock on the CPU),
    or warm_s when reps is 0. `last` holds the first call's result."""

    def __init__(self, device: torch.device, reps: int):
        self.cuda = device.type == "cuda"
        self.reps = reps
        self.last = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, name: str, fn):
        self._sync()
        t0 = time.perf_counter()
        self.last = fn()
        self._sync()
        warm = time.perf_counter() - t0
        best = warm if self.reps == 0 else float("inf")
        for _ in range(self.reps):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
        log(f"{name:16s} warm {warm:8.4f} s  best {best:10.6f} s")
        return {"warm_s": warm, "best_s": best}


def run(log_n: int, c: int, device: torch.device, piece: int = M.PIECE) -> dict:
    """Every stage at N = 2^log_n, window size c and piece size `piece`;
    returns the results."""
    n = 1 << log_n
    nw, nb = M.geometry(c)
    timeit = Timer(device, REPS[device.type])
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res = {"log_n": log_n, "c": c, "n": n, "nw": nw, "nb": nb, "device": name,
           "reps": timeit.reps, "no_counterpart": NO_COUNTERPART}
    log(f"N=2^{log_n} c={c}: {nw} windows of {nb} buckets on {name}")

    gens, scal = host_inputs(log_n)
    table = fixed_base_points(BN254_G1, bn254.G1_GEN, bn254.g1_add, gens, device)
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(device)

    res["digits"] = timeit("digits", lambda: M.recode(sc, c))
    res["plan(sort)"] = timeit("plan(sort)",
                               lambda: M.plan_msm(sc, c, split_heavy=False, piece=piece))
    plan = timeit.last
    res["occupancy"] = int((plan.starts[:, 1:] - plan.starts[:, :-1]).max())
    res.update(piece=plan.piece, pieces=plan.n_pieces, max_pieces=plan.max_pieces,
               combine_levels=len(plan.combine), combine_depth=plan.combine_depth)

    xs = table.xs
    xy = torch.cat([table.xs, table.ys], dim=1)
    visit = (plan.order[0] % n).to(torch.int32)  # window 0's rows in B5's order
    sel = lambda t, i, dim=0: lambda: torch.index_select(t, dim, i)  # noqa: E731
    library = [
        ("g_take_rows", sel(xs, visit), n),
        ("g_take_xy_rows", sel(xy, visit), n),
        ("g_take_limbmaj", sel(xs.T.contiguous(), visit, 1), n),
        ("g_take_pad128", sel(xy.repeat(1, 8), visit[: n // 8]), n // 8),
        ("g_take_sorted", sel(xs, torch.sort(visit).values), n),
    ]
    for stage, fn, m in library:
        t = timeit(stage, fn)
        res[stage] = {**t, "rows": m, "mrows_s": m / t["best_s"] / 1e6}

    rng = np.random.default_rng(SEED + 1)
    for stage, fn, tab, idx in gather_cases(xy, visit, rng):
        got = fn(tab, idx)
        if not torch.equal(got, G.gather_rows_plain(tab, idx)):
            raise RuntimeError(f"{stage}: {fn.__name__} differs from index_select")
        t = timeit(stage, lambda: fn(tab, idx))
        lib = timeit("  index_select", sel(tab, idx))
        m = int(idx.shape[0])
        res[stage] = {**t, "rows": m, "mrows_s": m / t["best_s"] / 1e6, "table": list(tab.shape),
                      "kernel": fn.__name__, "library_best_s": lib["best_s"]}

    res["full_group"] = timeit(
        "full_group", lambda: M.accumulate(BN254_G1, table.xs, table.ys, table.valid, 0, plan))
    buckets = timeit.last
    res["reduce"] = timeit("reduce", lambda: M.reduce(BN254_G1, buckets, nw, nb))

    res["msm"] = timeit("msm", lambda: M.msm(BN254_G1, table, sc, bn254.g1_add, bn254.g1_mul, c,
                                             piece))
    got = timeit.last
    want = bn254.g1_mul(bn254.G1_GEN, sum(s * k for s, k in zip(scal, gens)) % bn254.R)
    res["msm"].update(exact=got == want, x=str(got[0]) if got else None,
                      y=str(got[1]) if got else None)
    log(f"msm total {'exact' if got == want else 'WRONG'}")
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=20)
    ap.add_argument("c", nargs="?", type=int, default=13)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--piece", type=int, default=M.PIECE)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device (pass --device cpu to run the plain versions)")
        return 1
    res = run(args.log_n, args.c, torch.device(args.device), args.piece)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0 if res["msm"]["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
