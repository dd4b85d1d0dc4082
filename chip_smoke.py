#!/usr/bin/env python3
"""Smoke run of zkpoa_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain torch version, then prove layer one end to end.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds csrc/*.cu into build/torch_kernels/;
  3. kernels vs plain, exact equality of limbs, with both times:
     B1 field ops on 2^20 Fq and Fr pairs plus 0, 1 and p - 1; B2-B4 point
     ops on 2^16 G1 and G2 points plus infinity, P == Q, P == -Q and absent
     points; accumulation and reduction of a G1 MSM at 2^16 and a G2 MSM at
     2^14, both at the main path's window size (24 windows of 1024
     buckets); a G1 MSM at 2^20 checked exactly (P_i = g_i G, so the result
     is (sum s_i g_i mod r) G) and the same check for the 2^16 and 2^14 MSMs;
  4. main path: parse build/recursive_run/sigs.json, then the prover CLI
     `prove --layer one --repeat 2` (circuit build, setup_device, two proofs
     against the one key, each verified by the host pairing check); the
     launch counts of this phase alone must be non-zero for every kernel.
     Both proofs run in this process, after the kernel checks: the first
     is not a cold start;
  5. profile: one more layer-one key and three proofs, the last under
     torch.profiler; prints its wall time, the device's busy time as the
     union of kernel, memcpy and memset intervals, the idle share, the phase
     ends, the kernels by device time and the peak device memory. The
     trace goes to build/chip_smoke/prove_trace.json.
The second-to-last line is a JSON object listing every kernel; the last is
{"ok": true, "device": {...}}. Any failure exits non-zero before them.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # ptxas report, stats.json, trace
SIGS = os.path.join(REPO, "build", "recursive_run", "sigs.json")
LAYER_ONE_WIRES = 1_378_647  # witness length of layer one at 1 sig: the MSM plans' size
T0 = time.time()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "field_mont_mul": ("csrc/field_ops.cu", "zkpoa_tpu/ops/pallas_field.py:297"),
    "field_add_mod": ("csrc/field_ops.cu", "zkpoa_tpu/ops/pallas_field.py:297"),
    "field_sub_mod": ("csrc/field_ops.cu", "zkpoa_tpu/ops/pallas_field.py:297"),
    "point_add_affine_g1": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_add_affine_g2": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_add_g1": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_add_g2": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_double_g1": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_double_g2": ("csrc/point_ops.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "msm_accum_g1": ("csrc/msm_accum.cu", "zkpoa_tpu/ops/msm_pallas.py:1309"),
    "msm_accum_g2": ("csrc/msm_accum.cu", "zkpoa_tpu/ops/msm_pallas.py:1549"),
    "msm_reduce_g1": ("csrc/msm_reduce.cu", "zkpoa_tpu/ops/msm_pallas.py:666"),
    "msm_reduce_g2": ("csrc/msm_reduce.cu", "zkpoa_tpu/ops/msm_pallas.py:666"),
}


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events around `reps` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return -1
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


class Checks:
    def __init__(self, torch):
        self.torch = torch
        self.rows = {}

    def record(self, name, got, want, fn_kernel, fn_plain, reps=20, plain_reps=1):
        err = max_abs_err(self.torch, got, want)
        ms = time_ms(self.torch, fn_kernel, reps)
        plain_ms = time_ms(self.torch, fn_plain, plain_reps)
        self.rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"{name}: max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version")


def rand_field(torch, spec, n, gen, shape=()):
    """n random canonical elements (top limb below p's top limb) [n, *shape, 8]."""
    limbs = torch.randint(-(2**31), 2**31, (n,) + tuple(shape) + (8,), generator=gen,
                          dtype=torch.int64, device="cuda")
    top = spec.modulus >> 224
    limbs[..., 7] = torch.randint(0, top, (n,) + tuple(shape), generator=gen, device="cuda")
    return limbs.to(torch.int32)


def check_field(torch, checks, gen):
    from zkpoa_tpu_torch.ops import field_kernels as FK
    from zkpoa_tpu_torch.ops import limbs as L

    n = 1 << 20
    for spec in (L.BN254_FQ, L.BN254_FR):
        a = rand_field(torch, spec, n, gen)
        b = rand_field(torch, spec, n, gen)
        edge = spec.to_mont(torch.stack([spec.limbs_of(v, "cuda") for v in
                                         (0, 1, spec.modulus - 1)]))
        a = torch.cat([a, edge, edge])
        b = torch.cat([b, edge, edge.flip(0)])
        tag = spec.name.split("_")[1]
        for op, kname, plain in ((FK.OP_MUL, "field_mont_mul", L.mont_mul_plain),
                                 (FK.OP_ADD, "field_add_mod", L.add_mod_plain),
                                 (FK.OP_SUB, "field_sub_mod", L.sub_mod_plain)):
            got = FK.field_binop(spec, op, a, b)
            want = plain(spec, a, b)
            checks.record(f"{kname}[{tag}]", got, want,
                          lambda: FK.field_binop(spec, op, a, b), lambda: plain(spec, a, b))
        # host cross-check of a few products
        ints = lambda t: spec.decode(t)  # noqa: E731
        xs, ys, zs = ints(a[-8:]), ints(b[-8:]), ints(L.mont_mul(spec, a[-8:], b[-8:]))
        if zs != [x * y % spec.modulus for x, y in zip(xs, ys)]:
            fail(f"mont_mul[{tag}] disagrees with host integers")


def check_points(torch, checks, gen):
    from zkpoa_tpu_torch.ops import field_kernels as FK
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops.curve import BN254_G1, jac_add, jac_add_affine, jac_double, run_plain
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    n = 1 << 16
    for curve in (BN254_G1, BN254_G2):
        spec = curve.field
        shape = curve.coord_shape[:-1]
        rf = lambda: rand_field(torch, spec, n, gen, shape)  # noqa: E731
        p = (rf(), rf(), rf())
        q = (rf(), rf(), rf())
        xq, yq = rf(), rf()
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        one = L.to_i32(curve.arith("cuda").one_like(L.u32(p[0][:1]))[0])
        zero = torch.zeros_like(p[0][0])
        neg = lambda t: L.sub_mod_plain(spec, torch.zeros_like(t), t)  # noqa: E731
        # exceptional lanes: P = inf, Q = inf, Q = P, Q = -P, absent Q
        p[2][0] = zero
        q[2][1] = zero
        for i in range(3):
            q[i][2] = p[i][2]
        q[0][3], q[1][3], q[2][3] = p[0][3], neg(p[1][3]), p[2][3]
        p[0][4], p[1][4], p[2][4] = xq[4], yq[4], one
        p[0][5], p[1][5], p[2][5] = xq[5], neg(yq[5]), one
        p[2][6] = zero
        valid[7] = False
        g = curve.group
        ar = curve.arith("cuda")
        cases = (
            (f"point_add_affine_g{g}", lambda: FK.point_add_affine(g, p, xq, yq, valid),
             lambda: run_plain(ar, jac_add_affine, p, xq, yq, valid)),
            (f"point_add_g{g}", lambda: FK.point_add(g, p, q),
             lambda: run_plain(ar, jac_add, p, q)),
            (f"point_double_g{g}", lambda: FK.point_double(g, p),
             lambda: run_plain(ar, jac_double, p)),
        )
        for name, fk, fp in cases:
            checks.record(name, fk(), fp(), fk, fp)


def _fixed_base_points(torch, curve, base, host_add, gens):
    """Affine device table of g_i * base for 63-bit g_i (kernel path)."""
    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.ops.curve import fixed_base_mul_batch, jac_to_affine_mont
    from zkpoa_tpu_torch.ops.fp2 import g2_jac_to_affine_mont
    from zkpoa_tpu_torch.prover.setup import DeviceG1Points, DeviceG2Points

    sc = torch.from_numpy(host.scalars_to_limbs_fast(gens)).to("cuda")
    jac = fixed_base_mul_batch(curve, base, host_add, sc, 64)
    if curve.group == 1:
        return DeviceG1Points(*jac_to_affine_mont(curve.field, jac))
    return DeviceG2Points(*g2_jac_to_affine_mont(jac))


def check_msm(torch, checks, gen):
    import numpy as np

    from zkpoa_tpu.fields import bn254
    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.ops import msm as M
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    rng = np.random.default_rng(0)
    c = M.auto_c(LAYER_ONE_WIRES)  # the window size of every MSM of the main path
    for curve, base, add, mul, log_n in (
        (BN254_G1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, 16),
        (BN254_G2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, 14),
    ):
        n = 1 << log_n
        g = curve.group
        gens = [int(x) for x in rng.integers(1, 2**63, size=n, dtype=np.uint64)]
        table = _fixed_base_points(torch, curve, base, add, gens)
        scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
        sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
        plan = M.plan_msm(sc, c, split_heavy=False)
        acc = lambda: M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan)  # noqa: E731
        acc_plain = lambda: M.accumulate_plain(  # noqa: E731
            curve, table.xs, table.ys, table.valid, 0, plan)
        buckets = acc()
        checks.record(f"msm_accum_g{g}", buckets, acc_plain(), acc, acc_plain, reps=3)
        red = lambda: M.reduce(curve, buckets, plan.nw, plan.nb)  # noqa: E731
        red_plain = lambda: M.reduce_plain(curve, buckets, plan.nw, plan.nb)  # noqa: E731
        checks.record(f"msm_reduce_g{g}", red(), red_plain(), red, red_plain, reps=5)
        got = M.msm_shared(curve, table, plan, add, mul)
        want = mul(base, sum(s * k for s, k in zip(scal, gens)) % bn254.R)
        if got != want:
            fail(f"G{g} MSM at 2^{log_n} is wrong")
        log(f"G{g} MSM at 2^{log_n} (c={c}: {plan.nw} windows of {plan.nb} buckets): exact")

    # the headline G1 MSM at 2^20, bench.py's exact check
    n = 1 << 20
    gens = [int(x) for x in rng.integers(1, 2**63, size=n, dtype=np.uint64)]
    table = _fixed_base_points(torch, BN254_G1, bn254.G1_GEN, bn254.g1_add, gens)
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
    run = lambda: M.msm(BN254_G1, table, sc, bn254.g1_add, bn254.g1_mul)  # noqa: E731
    got = run()
    want = bn254.g1_mul(bn254.G1_GEN, sum(s * k for s, k in zip(scal, gens)) % bn254.R)
    if got != want:
        fail("G1 MSM at 2^20 is wrong")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"G1 MSM at 2^20 (c={M.auto_c(n)}, plan included): exact; "
        f"{best * 1e3:.1f} ms -> {n / best / 1e6:.3f} Mpoints/s (runs {times})")
    return {"g1_msm_2p20_s": best, "g1_msm_2p20_mpoints_s": n / best / 1e6}


def main_path(torch):
    from zkpoa_tpu.prover import groth16
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli

    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "layer_one_input.json")
        with open(inp, "w") as f:
            json.dump(layer_one_input(parse_signatures_file(SIGS)), f)
        out = os.path.join(tmp, "out")
        _build.reset_counts()
        rc = cli.main(["prove", "--layer", "one", "--input", inp, "--device", "cuda",
                       "-o", out, "--repeat", "2"])
        torch.cuda.synchronize()
        counts = dict(_build.COUNTS)
        if rc != 0:
            fail(f"prover CLI exited {rc}")
        with open(os.path.join(out, "stats.json")) as f:
            stats = json.load(f)
        ok = groth16.verify_files(os.path.join(out, "layer_one_vkey.json"),
                                  os.path.join(out, "proof.json"),
                                  os.path.join(out, "public.json"))
        if not ok:
            fail("proof.json does not verify")
    log(f"layer one: {stats['constraints']} constraints, {stats['wires']} wires, domain "
        f"2^{stats['domain'].bit_length() - 1}; build {stats['build_s']:.2f} s, setup_device "
        f"{stats['setup_s']:.2f} s, first prove {stats['prove_s'][0]:.2f} s, second "
        f"{stats['prove_s'][1]:.2f} s (in a process warmed by the kernel checks); host verify "
        f"{stats['verify_s']}")
    log(f"launches in the main path: {json.dumps(counts, sort_keys=True)}")
    missing = [k for k in KERNELS if counts.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched by the main path: {missing}")
    return stats, counts


def busy_us(events) -> float:
    """Length of the union of device intervals (chrome-trace events with
    ts and dur in microseconds)."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def profile_prove(torch):
    """A warm layer-one prove under torch.profiler: wall, device busy time
    and idle share, phase ends, kernels by device time, peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from zkpoa_tpu.prover import groth16
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover.prove import _sync, prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    circuit, _name = cli._build_circuit("one", layer_one_input(parse_signatures_file(SIGS)), False)
    r1cs, witness = circuit.compile()
    pk = setup_device(r1cs, "cuda")
    unprofiled = []
    for _ in range(2):
        t0 = time.perf_counter()
        prove(pk, r1cs, witness, "cuda")
        _sync("cuda")
        unprofiled.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    phases = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof = prove(pk, r1cs, witness, "cuda", log=phases.append)
        _sync("cuda")
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not groth16.verify(groth16.VerifyingKey.from_json(pk.vk_json), proof,
                          circuit.public_values):
        fail("the profiled proof does not verify")
    path = os.path.join(OUT_DIR, "prove_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    dev = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = busy_us(dev) / 1e6
    by_name = {}
    for e in dev:
        name = e["name"].split("(")[0].replace("void ", "")
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"profile: unprofiled warm proves {[round(t, 3) for t in unprofiled]} s; profiled "
        f"prove wall {wall:.3f} s, device busy {busy:.3f} s ({len(dev)} device events), "
        f"idle {100 * (1 - busy / wall):.1f} %; peak device memory {peak / 2**30:.2f} GiB")
    log("profile phase ends: " + "; ".join(p.removeprefix("prove: ") for p in phases))
    for name, (ms, n) in top:
        log(f"profile kernel {ms:9.3f} ms {n:5d}x {name[:110]}")
    if not dev:
        fail("the profiled prove shows no device work")
    return {"unprofiled_s": unprofiled, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall, "peak_bytes": peak, "phases": phases,
            "top": [[name, ms, n] for name, (ms, n) in top]}


def ptxas_summary(path: str) -> str:
    import re

    regs, spills = [], 0
    with open(path) as f:
        for line in f:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills += int(m.group(1))
    return f"{len(regs)} kernels, max {max(regs) if regs else 0} registers, spill stores {spills} bytes"


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "zkpoa_tpu_torch", "csrc")):
        fail("the zkpoa_tpu_torch package is not beside this script")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    os.makedirs(OUT_DIR, exist_ok=True)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from zkpoa_tpu_torch import _build

    t0 = time.time()
    _build.lib()
    log(f"build: {time.time() - t0:.1f} s ({_build.BUILD_INFO.get('path')}); "
        f"ptxas: {ptxas_summary(_build.BUILD_INFO['log'])}")
    with open(_build.BUILD_INFO["log"]) as f, open(os.path.join(OUT_DIR, "ptxas.log"), "w") as g:
        g.write(f.read())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = Checks(torch)
    check_field(torch, checks, gen)
    check_points(torch, checks, gen)
    msm_stats = check_msm(torch, checks, gen)
    stats, counts = main_path(torch)
    prof = profile_prove(torch)
    with open(os.path.join(OUT_DIR, "stats.json"), "w") as f:
        json.dump({"main_path": stats, "launches": counts, "kernels": checks.rows,
                   "msm": msm_stats, "profile": prof, "device": name, "smi": smi}, f, indent=1)

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        rows = [r for k, r in checks.rows.items() if k.split("[")[0] == kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"zkpoa_tpu_torch/{src}",
            "replaces": replaces, "launches": counts.get(kname, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
