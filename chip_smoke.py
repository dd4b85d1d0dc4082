#!/usr/bin/env python3
"""Smoke run of zkpoa_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain torch version, prove layer one end to end, run
the three-layer workflow in full mode, run the MSM stage harness at 2^20
and build a 2^20-leaf Merkle tree.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds csrc/*.cu into build/torch_kernels/;
  3. kernels vs plain, exact equality of limbs, with both times and each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its int32
     operations over the card's int32 issue rate):
     B1 field ops on 2^20 Fq and Fr pairs plus 0, 1 and p - 1; B2-B4 point
     ops on 2^16 G1 and G2 points plus infinity, P == Q, P == -Q and absent
     points; B8 fixed-base multiplication of 2^16 G1 and 2^14 G2 254-bit
     scalars with 0, 1, r - 1, r, 2^248, all digits equal and a top-window
     P == Q among them (decoded points checked against host scalar
     multiplication, and the B2-loop route, 32 launches of B2, timed beside
     it); accumulation and reduction of a G1 MSM at 2^16 and a G2 MSM at
     2^14, both at the main path's window size (24 windows of 1024
     buckets), each MSM's total checked exactly (P_i = g_i G, so the result
     is (sum s_i g_i mod r) G);
  4. main path, layer one: parse build/recursive_run/sigs.json, then the
     prover CLI `prove --layer one --repeat 2` (circuit build, setup_device,
     two proofs against the one key, each verified by the host pairing
     check). Both proofs run in this process, after the kernel checks: the
     first is not a cold start;
  5. main path, workflow: `python -m zkpoa_tpu_torch.pipeline.workflow`
     in full mode on build/recursive_run2 (2 signatures, 2 batches, tree
     height 5, blinding factor 0xB11DD1E5), in process through `main`; the
     Merkle root, balance sum 657 and the 13 layer-three public values must
     equal the recorded run's, every proof.json written must verify, and
     B8 must have run in its setups;
  6. setup A/B: setup_device of the workflow's three layer circuits with B8
     and with the B2-loop route, in turns B2, B8, B8, B2;
  7. MSM stages: the harness's CLI, `python -m
     zkpoa_tpu_torch.experiments.msm_stages 20 c`, in process through
     `main`, for c = 11 (the main path's window) and c = 13 (the JAX
     harness's): every stage of a G1 MSM over 2^20 points P_i = g_i G
     timed, the gather kernels E1-E3 raced against index_select, the MSM
     total exact; its JSON goes to build/chip_smoke/msm_stages.json. Then
     E1-E3 against the plain version (exact equality) at the harness's
     shapes, each with its bound (bytes M W 4 written, 4 M of indices and
     D W 4 read for the D distinct rows indexed) and the index_select time
     (the plain version is index_select, so its time is also the library
     time). The c = 11 run's whole-MSM stage is the G1 MSM at 2^20 in
     Mpoints/s. The launch counts of phases 4, 5 and 7 (each reset just
     before it) must together be non-zero for every kernel;
  8. Merkle: a tree over 2^20 leaves (height 21) from numpy seed 0, timed,
     4 random leaves and their proofs checked with the host Poseidon;
  9. profile: one more layer-one key and three proofs, the last under
     torch.profiler; prints its wall time, the device's busy time as the
     union of kernel, memcpy and memset intervals, the idle share, the phase
     ends, the kernels by device time and the peak device memory. The
     trace goes to build/chip_smoke/prove_trace.json.
The second-to-last line is a JSON object listing every kernel; the last is
{"ok": true, "device": {...}}. Any failure exits non-zero before them.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")  # ptxas report, stats.json, trace
SIGS = os.path.join(REPO, "build", "recursive_run", "sigs.json")
RUN2 = os.path.join(REPO, "build", "recursive_run2")  # the workflow's inputs and recorded outputs
GOLDEN = os.path.join(RUN2, "2_sigs_2_batches_5_height")
BLIND = "0xB11DD1E5"
LAYER_ONE_WIRES = 1_378_647  # witness length of layer one at 1 sig: the MSM plans' size
MSM_STAGES_LOG_N = 20  # the MSM stage harness's size, its default
T0 = time.time()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# kernel name -> (source, TPU kernel it replaces); each is launched by one
# of the phases that drive a path: layer one, the workflow, the MSM stages
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
    "fixed_base_g1": ("csrc/fixed_base.cu", "zkpoa_tpu/ops/curve_jax.py:369"),
    "fixed_base_g2": ("csrc/fixed_base.cu", "zkpoa_tpu/ops/curve_jax.py:369"),
    "gather_smem_rows": ("csrc/gather.cu", "experiments/msm_stages.py:91"),
    "gather_smem_vec": ("csrc/gather.cu", "experiments/msm_stages.py:110"),
    "gather_async": ("csrc/gather.cu", "experiments/msm_stages.py:150"),
}

# The bound of a kernel is the larger of its bytes over the memory rate and
# its int32 operations over the issue rate (NVIDIA H100 SXM data sheet and
# Hopper white paper: 3.35 TB/s; 132 SMs x 64 int32 lanes x 1.98 GHz). A
# 32 x 32 -> 64-bit multiply-add counts as two int32 operations, so a
# Montgomery product of 8 x 32-bit limbs (64 for the product, 64 for the
# reduction) is 256; additions are not counted.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
MONT_OPS = 256
# Montgomery products per point formula (curve.cuh), G1 over Fq, G2 over
# Fq2 counted as 3 Fq products per product and 2 per square
PRODUCTS = {
    "add_affine": {1: 11, 2: 8 * 3 + 3 * 2},
    "add": {1: 16, 2: 12 * 3 + 4 * 2},
    "double": {1: 7, 2: 2 * 3 + 5 * 2},
}
COORD_BYTES = {1: 32, 2: 64}


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) of work moving n_bytes and doing n_ops."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / INT32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    def record(self, name, got, want, fn_kernel, fn_plain, work, reps=20, plain_reps=1,
               plain_is_library=False):
        """work = (bytes, int32 operations) of one call, for its bound;
        plain_is_library: fn_plain is one PyTorch call computing the same
        function, so its time is also the library time (else there is none)."""
        err = max_abs_err(self.torch, got, want)
        ms = time_ms(self.torch, fn_kernel, reps)
        plain_ms = time_ms(self.torch, fn_plain, plain_reps)
        library_ms = plain_ms if plain_is_library else None
        bound_ms, bound_by = bound(*work)
        self.rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"{name}: max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {work[0]:.4g} B, {work[1]:.4g} int32 ops)")
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
        m = a.shape[0]
        for op, kname, plain, ops in ((FK.OP_MUL, "field_mont_mul", L.mont_mul_plain, MONT_OPS),
                                      (FK.OP_ADD, "field_add_mod", L.add_mod_plain, 16),
                                      (FK.OP_SUB, "field_sub_mod", L.sub_mod_plain, 16)):
            got = FK.field_binop(spec, op, a, b)
            want = plain(spec, a, b)
            checks.record(f"{kname}[{tag}]", got, want,
                          lambda: FK.field_binop(spec, op, a, b), lambda: plain(spec, a, b),
                          (3 * 32 * m, ops * m))
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
        cb = COORD_BYTES[g]
        cases = (
            (f"point_add_affine_g{g}", lambda: FK.point_add_affine(g, p, xq, yq, valid),
             lambda: run_plain(ar, jac_add_affine, p, xq, yq, valid), (8 * cb + 1, "add_affine")),
            (f"point_add_g{g}", lambda: FK.point_add(g, p, q),
             lambda: run_plain(ar, jac_add, p, q), (9 * cb, "add")),
            (f"point_double_g{g}", lambda: FK.point_double(g, p),
             lambda: run_plain(ar, jac_double, p), (6 * cb, "double")),
        )
        for name, fk, fp, (nbytes, formula) in cases:
            checks.record(name, fk(), fp(), fk, fp,
                          (nbytes * n, PRODUCTS[formula][g] * MONT_OPS * n))


def fixed_base_b2_loop(ops, base, host_add, scalars, n_bits):
    """The B2-loop route of fixed-base multiplication on the card (setup's
    route before B8), kept here as a yardstick for B8: one gather and one
    B2 launch per 8-bit window."""
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops.curve import FB_WINDOW, fixed_base_device_table

    xs_t, ys_t, valid_t = fixed_base_device_table(ops, base, host_add, n_bits, scalars.device)
    sc = L.u32(scalars)
    acc = ops.infinity((scalars.shape[0],), scalars.device)
    for j in range((n_bits + FB_WINDOW - 1) // FB_WINDOW):
        limb, sh = divmod(j * FB_WINDOW, 32)
        idx = (sc[:, limb] >> sh) & ((1 << FB_WINDOW) - 1)
        acc = ops.add_affine(acc, xs_t[j][idx], ys_t[j][idx], valid_t[j][idx])
    return acc


def check_fixed_base(torch, checks):
    """B8 against its plain version at setup's 254 bits: G1 at 2^16 and G2
    at 2^14 scalars, edge cases first; a few decoded against the host."""
    import numpy as np

    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.fields import bn254
    from zkpoa_tpu_torch.ops.curve import (BN254_G1, FB_WINDOW, fixed_base_device_table,
                                           fixed_base_mul_batch, fixed_base_plain)
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    r = bn254.R
    # the top window adds (d 2^248) G to k mod 2^248: k = r is P == -Q (d = 48),
    # k = 98 * 2^248 - r is P == Q (d = 49)
    edge = [0, 1, r - 1, r, 1 << 248, int("15" * 32, 16), 98 * (1 << 248) - r]
    rng = np.random.default_rng(1)
    out = {}
    for curve, base, add, mul, log_n in ((BN254_G1, bn254.G1_GEN, bn254.g1_add, bn254.g1_mul, 16),
                                         (BN254_G2, bn254.G2_GEN, bn254.g2_add, bn254.g2_mul, 14)):
        n, g = 1 << log_n, curve.group
        scal = edge + [int.from_bytes(rng.bytes(32), "big") % r for _ in range(n - len(edge))]
        sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
        tab = fixed_base_device_table(curve, base, add, 254, sc.device)
        kern = lambda: fixed_base_mul_batch(curve, base, add, sc, 254)  # noqa: E731
        plain = lambda: fixed_base_plain(curve, *tab, sc, 254)  # noqa: E731
        got = kern()
        nwin = (254 + FB_WINDOW - 1) // FB_WINDOW
        digits = sum(1 for k in scal for j in range(nwin) if (k >> (FB_WINDOW * j)) & 255)
        cb = COORD_BYTES[g]
        work = (nwin * 256 * (2 * cb + 1) + n * (32 + 3 * cb),
                digits * PRODUCTS["add_affine"][g] * MONT_OPS)
        checks.record(f"fixed_base_g{g}", got, plain(), kern, plain, work, reps=5)
        pick = list(range(len(edge))) + [len(edge), n - 1]
        dec = curve.decode_jac(tuple(t[pick] for t in got))
        if dec != [mul(base, scal[i]) for i in pick]:
            fail(f"fixed_base_g{g} disagrees with host scalar multiplication")
        b2 = time_ms(torch, lambda: fixed_base_b2_loop(curve, base, add, sc, 254), 3)
        out[f"g{g}"] = {"n": n, "b8_ms": checks.rows[f"fixed_base_g{g}"]["ms"], "b2_loop_ms": b2}
        log(f"fixed_base_g{g} at 2^{log_n}: host decode of {len(pick)} points exact; "
            f"B2-loop route {b2:.3f} ms")
    return out


def check_msm(torch, checks, gen):
    import numpy as np

    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.experiments.msm_stages import fixed_base_points
    from zkpoa_tpu_torch.fields import bn254
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
        table = fixed_base_points(curve, base, add, gens, "cuda")
        scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
        sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
        plan = M.plan_msm(sc, c, split_heavy=False)
        acc = lambda: M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan)  # noqa: E731
        acc_plain = lambda: M.accumulate_plain(  # noqa: E731
            curve, table.xs, table.ys, table.valid, 0, plan)
        buckets = acc()
        cb = COORD_BYTES[g]
        adds = int(plan.starts[:, -1].sum())  # entries in some bucket: one mixed add each
        lanes = plan.nw * plan.nb
        checks.record(f"msm_accum_g{g}", buckets, acc_plain(), acc, acc_plain,
                      (n * (2 * cb + 1) + 4 * plan.nw * n + 4 * plan.nw * (plan.nb + 1)
                       + 3 * cb * lanes, adds * PRODUCTS["add_affine"][g] * MONT_OPS), reps=3)
        red = lambda: M.reduce(curve, buckets, plan.nw, plan.nb)  # noqa: E731
        red_plain = lambda: M.reduce_plain(curve, buckets, plan.nw, plan.nb)  # noqa: E731
        checks.record(f"msm_reduce_g{g}", red(), red_plain(), red, red_plain,
                      (3 * cb * (lanes + plan.nw),
                       2 * lanes * PRODUCTS["add"][g] * MONT_OPS), reps=5)
        got = M.msm_shared(curve, table, plan, add, mul)
        want = mul(base, sum(s * k for s, k in zip(scal, gens)) % bn254.R)
        if got != want:
            fail(f"G{g} MSM at 2^{log_n} is wrong")
        log(f"G{g} MSM at 2^{log_n} (c={c}: {plan.nw} windows of {plan.nb} buckets): exact")


def main_path(torch):
    """Phase 4: the layer-one prover CLI, launch counts of this phase alone."""
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import groth16

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
    log(f"launches in the layer-one phase: {json.dumps(counts, sort_keys=True)}")
    return stats, counts


def workflow_path(torch, tmp):
    """Phase 5: the full-mode workflow on the recorded run's inputs through
    the CLI's main; its outputs against the recorded ones."""
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline import workflow
    from zkpoa_tpu_torch.prover import groth16

    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    rc = workflow.main([os.path.join(RUN2, "sigs.json"), os.path.join(RUN2, "anon.csv"), BLIND,
                        "-p", "1", "-m", "full", "--device", "cuda", "-b", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"workflow exited {rc}")
    bdir = os.path.join(tmp, "2_sigs_2_batches_5_height")

    def load(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    if load(bdir, "merkle_root.json") != load(GOLDEN, "merkle_root.json"):
        fail("workflow Merkle root differs from the recorded run's")
    balances = [int(load(bdir, f"batch_{b}", "public.json")[0]) for b in range(2)]
    if sum(balances) != 657:
        fail(f"workflow balance sum {sum(balances)} (balances {balances}), expected 657")
    l3 = load(bdir, "layer_three", "public.json")
    if l3 != load(GOLDEN, "layer_three", "commitment.json") or len(l3) != 13:
        fail("workflow layer-three public values differ from the recorded commitment")
    proofs = [(os.path.join(bdir, f"batch_{b}"), "layer_two") for b in range(2)]
    proofs.append((os.path.join(bdir, "layer_three"), "layer_three"))
    for d, name in proofs:
        if not groth16.verify_files(os.path.join(d, f"{name}_vkey.json"),
                                    os.path.join(d, "proof.json"), os.path.join(d, "public.json")):
            fail(f"{d}/proof.json does not verify")
    for k in ("fixed_base_g1", "fixed_base_g2"):
        if counts.get(k, 0) == 0:
            fail(f"{k} was not launched by the workflow's setups")
    with open(os.path.join(bdir, "benchmarks.txt")) as f:
        bench = f.read()
    for line in bench.splitlines():
        if line.strip():
            log(f"workflow {line.strip()}")
    log(f"workflow: wall {wall:.2f} s, balances {balances} (sum 657), root and 13 layer-three "
        f"values equal the recorded run's, 3 proof.json verified (the layer-one proofs are "
        f"verified inside the run); peak device memory {peak / 2**30:.2f} GiB")
    log(f"launches in the workflow phase: {json.dumps(counts, sort_keys=True)}")
    return {"wall_s": wall, "peak_bytes": peak, "benchmarks": bench}, counts, bdir


def setup_ab(torch, bdir):
    """Phase 6: setup_device of each workflow layer circuit with B8 and with
    the B2-loop route, in turns B2, B8, B8, B2; keys must agree."""
    from zkpoa_tpu_torch.models.layers import LayerTwoInput, layer_three_circuit, layer_two_circuit
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import setup as setup_mod

    with open(os.path.join(bdir, "batch_0", "layer_one_input.json")) as f:
        c1, _ = cli._build_circuit("one", json.load(f), False)
    with open(os.path.join(bdir, "batch_0", "layer_two_input.json")) as f:
        d2 = json.load(f)
    d2.pop("proof", None)
    ints = lambda x: [ints(y) for y in x] if isinstance(x, list) else int(x)  # noqa: E731
    c2 = layer_two_circuit(LayerTwoInput(**{k: ints(v) for k, v in d2.items()}), tree_height=5)
    with open(os.path.join(bdir, "merkle_root.json")) as f:
        root = int(json.load(f))
    c3 = layer_three_circuit([419, 238], root, int(BLIND, 16))
    b8 = setup_mod.fixed_base_mul_batch
    out = {}
    for name, circuit in (("layer one", c1), ("layer two", c2), ("layer three", c3)):
        r1cs, _ = circuit.compile()
        times = {"b2_loop": [], "b8": []}
        keys = {}
        for route in ("b2_loop", "b8", "b8", "b2_loop"):
            setup_mod.fixed_base_mul_batch = fixed_base_b2_loop if route == "b2_loop" else b8
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pk = setup_mod.setup_device(r1cs, "cuda")
                torch.cuda.synchronize()
                times[route].append(time.perf_counter() - t0)
            finally:
                setup_mod.fixed_base_mul_batch = b8
            keys[route] = (pk.a_query.xs[-4:].cpu(), pk.b2_query.ys[-4:].cpu(), pk.vk_json)
            del pk
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(keys["b8"], keys["b2_loop"]))
        if not same:
            fail(f"{name}: the B8 key differs from the B2-loop key")
        out[name] = {"constraints": r1cs.n_constraints, **times}
        log(f"setup A/B {name} ({r1cs.n_constraints} constraints): B2 loop "
            f"{[round(t, 3) for t in times['b2_loop']]} s, B8 {[round(t, 3) for t in times['b8']]} s")
    return out


def msm_stages_path(torch, checks):
    """Phase 7: the MSM stage harness's CLI at 2^20 for c = 11 and 13, the
    launch counts of both runs; then E1-E3 against the plain version at the
    harness's shapes."""
    import numpy as np

    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.experiments import msm_stages as H
    from zkpoa_tpu_torch.ops import gather as G
    from zkpoa_tpu_torch.ops import msm as M

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_counts()
        for c in (M.auto_c(LAYER_ONE_WIRES), 13):
            path = os.path.join(tmp, f"c{c}.json")
            # its stdout repeats the --out JSON; this script's stdout ends in the contract lines
            with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
                rc = H.main([str(MSM_STAGES_LOG_N), str(c), "--device", "cuda", "--out", path])
            if rc != 0:
                fail(f"msm_stages at c = {c} exited {rc}")
            with open(path) as f:
                runs[f"c{c}"] = json.load(f)
        torch.cuda.synchronize()
        counts = dict(_build.COUNTS)
    with open(os.path.join(OUT_DIR, "msm_stages.json"), "w") as f:
        json.dump(runs, f, indent=1)
    summary = {}
    for name, res in runs.items():
        if not res["msm"]["exact"]:
            fail(f"msm_stages {name}: the MSM total is wrong")
        summary[name] = {k: v["best_s"] for k, v in res.items()
                         if isinstance(v, dict) and "best_s" in v}
        log(f"msm_stages 2^{MSM_STAGES_LOG_N} {name} (occupancy {res['occupancy']}), best ms: "
            + ", ".join(f"{k} {t * 1e3:.4f}" for k, t in summary[name].items()) + "; MSM exact")
    log(f"launches in the msm_stages phase: {json.dumps(counts, sort_keys=True)}")
    # the headline G1 MSM at 2^20 (bench.py's metric and exact check) at the main path's window
    best = summary[f"c{M.auto_c(LAYER_ONE_WIRES)}"]["msm"]
    msm = {"g1_msm_2p20_s": best, "g1_msm_2p20_mpoints_s": (1 << MSM_STAGES_LOG_N) / best / 1e6}
    log(f"G1 MSM at 2^{MSM_STAGES_LOG_N} (plan included): exact; {best * 1e3:.2f} ms -> "
        f"{msm['g1_msm_2p20_mpoints_s']:.3f} Mpoints/s")

    # E1-E3 against the plain version on random rows at the harness's shapes;
    # E3 at the MSM's shape first, the row the kernels line reports
    n = 1 << MSM_STAGES_LOG_N
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    xy = torch.randint(-(2**31), 2**31, (n, 16), generator=gen, dtype=torch.int64,
                       device="cuda").to(torch.int32)
    visit = torch.randint(0, n, (n,), generator=gen, device="cuda").to(torch.int32)
    cases = H.gather_cases(xy, visit, np.random.default_rng(1))
    cases.sort(key=lambda case: case[0] != "g_dma_msm")
    for stage, fn, tab, idx in cases:
        m, w = idx.shape[0], tab.shape[1]
        distinct = torch.unique(idx).numel()  # rows the gather must read at least once
        checks.record(f"{fn.__name__}[{stage}]", fn(tab, idx), G.gather_rows_plain(tab, idx),
                      lambda: fn(tab, idx), lambda: G.gather_rows_plain(tab, idx),
                      (m * w * 4 + 4 * m + distinct * w * 4, 0), plain_reps=20,
                      plain_is_library=True)  # the plain version is index_select
    return summary, counts, msm


def merkle_2p20(torch):
    """Phase 8: a Merkle tree over 2^20 leaves (height 21); 4 sampled leaves
    and proofs against the host Poseidon."""
    import numpy as np

    from zkpoa_tpu_torch.merkle.tree import MerkleTree, verify_proof
    from zkpoa_tpu_torch.ops import poseidon as poseidon_host

    rng = np.random.default_rng(0)
    n = 1 << 20
    blob = rng.bytes(20 * n)
    addrs = [int.from_bytes(blob[20 * i : 20 * i + 20], "big") for i in range(n)]
    bals = [int(x) for x in rng.integers(0, 2**64, size=n, dtype=np.uint64)]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = MerkleTree.build(addrs, bals, 21, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    MerkleTree.from_leaves_mont(tree._levels[0])
    torch.cuda.synchronize()
    levels_s = time.perf_counter() - t0
    root = tree.root()
    for i in rng.choice(n, size=4, replace=False).tolist():
        p = tree.prove(i)
        if p.leaf != poseidon_host.poseidon2(addrs[i], bals[i]) or not verify_proof(root, p):
            fail(f"Merkle leaf {i} or its proof does not check against the host Poseidon")
    log(f"Merkle 2^20 leaves (height 21): build {[round(t, 3) for t in times]} s "
        f"(first includes the Poseidon constants; host encoding of the leaves included), "
        f"the 2^20 - 1 node hashes alone {levels_s:.3f} s; 4 sampled leaves and proofs verified")
    return {"build_s": times, "levels_s": levels_s}


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

    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import groth16
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
    fb_stats = check_fixed_base(torch, checks)
    check_msm(torch, checks, gen)
    stats, counts_l1 = main_path(torch)
    with tempfile.TemporaryDirectory() as tmp:
        wf, counts_wf, bdir = workflow_path(torch, tmp)
        ab = setup_ab(torch, bdir)
    stages, counts_ms, msm_stats = msm_stages_path(torch, checks)
    counts = {k: counts_l1.get(k, 0) + counts_wf.get(k, 0) + counts_ms.get(k, 0)
              for k in set(counts_l1) | set(counts_wf) | set(counts_ms)}
    missing = [k for k in KERNELS if counts.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched by the layer-one, workflow and msm_stages phases: {missing}")
    merkle = merkle_2p20(torch)
    prof = profile_prove(torch)
    with open(os.path.join(OUT_DIR, "stats.json"), "w") as f:
        json.dump({"main_path": stats, "launches": counts, "launches_layer_one": counts_l1,
                   "launches_workflow": counts_wf, "launches_msm_stages": counts_ms,
                   "kernels": checks.rows, "fixed_base": fb_stats, "msm": msm_stats,
                   "msm_stages": stages, "workflow": wf, "setup_ab": ab, "merkle": merkle,
                   "profile": prof, "device": name, "smi": smi}, f, indent=1)

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        rows = [r for k, r in checks.rows.items() if k.split("[")[0] == kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"zkpoa_tpu_torch/{src}",
            "replaces": replaces, "launches": counts.get(kname, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0]["library_ms"],  # None where no PyTorch call computes it
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
