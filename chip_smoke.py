#!/usr/bin/env python3
"""Smoke run of zkpoa_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain torch version, prove layer one end to end, run
the three-layer workflow in full mode, prove the recursive layer two (the
in-snark verifier of layer one, at 2^23), run the MSM stage harness at
2^20, run the powers-of-tau ceremony path at power 21 (the workflow with
keys from the ceremony) and build a 2^20-leaf Merkle tree.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: nvcc builds csrc/*.cu into build/torch_kernels/; the registers,
     stack frame and spills of every MSM kernel (B5/B6's piece and combine
     kernels, B7, Horner), of the fold kernel, of the NTT pass kernel, of
     the two kernels on the row-accumulation core (B8 fixed_base and the
     heavy-value rounds) and of the ladder kernels (K1 scalar_mul, K2
     ntt_stage; G1, and G2 on one and on three threads a lane) from the
     ptxas log, on a line of their own;
  3. kernels vs plain, exact equality of limbs, with both times and each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its int32
     operations over the card's int32 issue rate):
     B1 field ops on 2^20 Fq and Fr pairs plus every pair of carry-heavy
     values (0, 1, 2, p - 1, p - 2, (p -+ 1) / 2, k limbs of 0xffffffff,
     p - 2^32, 2^255 mod p: a - b = 0, a < b, a + b just under, at and just
     over p), those pairs also against host integers, and products with one
     operand that is not canonical (2^256 - 1, p, 2p - 1, ...) inside the
     contract a.b < 2^256 p; the NTT pass kernel at the layer-one domain,
     2^21 (two passes), and at the recursive layer two's, 2^23 (three
     passes), forward and inverse, against the per-stage plain version,
     with the per-stage route through elementwise B1 launches (the port's
     transform before the pass kernel) timed beside it; B2-B4 point
     ops on 2^16 G1 and G2 points plus infinity, P == Q, P == -Q and absent
     points; B8 fixed-base multiplication of 2^16 G1 and 2^14 and 2^16 G2
     254-bit scalars (G2 in both lane layouts) with 0, 1, r - 1, r, 2^248, all digits equal and a top-window
     P == Q among them (decoded points checked against host scalar
     multiplication, and the B2-loop route, 32 launches of B2, timed beside
     it); the heavy-value rounds kernel at a warm layer-one prove's shape
     (G1 three tables, G2 one, 8 heavy runs each, 2^16 lanes a segment, the
     widest run 9 rounds; rows out of range and not valid, P == Q and
     P == -Q inside a lane), with the B2 rounds route (a B2 launch a round and
     the re-concatenated lane array) timed beside it and equal to it;
     accumulation of a G1 MSM at 2^16 and a G2 MSM at 2^14, both at
     the main path's window size (24 windows of 1024 buckets), with the
     plan's piece count and combine depth; reduction as the main path calls
     it, G1 over four MSMs' buckets (96 windows) in one launch and over one
     (24), G2 over one; Horner over those window totals as the main path
     calls it (msm_horner: G1 four MSMs, G2 one, c = 11); the fold of the
     heavy-value sums at the main path's shape (point_fold: 24 segments of
     2^16 lanes G1, 8 G2); each MSM's total checked exactly (P_i = g_i G,
     so the result is (sum s_i g_i mod r) G). B7, Horner and the fold also
     get a latency bound: the dependent Montgomery products on the chain's
     critical path times one product's latency, measured first by a
     one-thread chain of 2^16 products (`zk_mont_chain`);
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
  5b. main path, recursive layer two: the layer-two circuit of the recorded
     run's batch 0 with the in-snark Groth16 verifier of the workflow
     phase's own batch-0 layer-one proof (its layer_one_sanitized_proof.json,
     layer_one_vkey.json and layer_two_input.json), about 7M constraints at
     a 2^23 domain: built on the host, set up and proved on the card; the
     host verifier must accept the proof and its public values must equal
     the recorded batch_0/public.json. The circuit comes from the
     workflow's own `load_layer_two_input` and
     `recursive_layer_two_circuit`. Logs constraints and domain, build,
     setup and prove seconds, the prove's phase ends, peak host RSS beside
     the host's RAM, peak device memory (setup's, and each prove phase's,
     the MSM plans' among them) and the phase's launches by kernel. Then,
     outside the launch counts, the kernels whose shapes this prove alone
     gives are held against their plain versions on its own key: the
     heavy-value rounds kernel at its heavy segments, and the bucket
     accumulation over its witness plan (G2, b2-query) and over a plan of
     dense scalars as long as its h-query (G1, the h MSM's shape, 24
     windows over about 2^23 scalars), each plain version run once and
     timed by that run;
  6. setup A/B: setup_device of the workflow's three layer circuits with B8
     and with the B2-loop route, in turns B2, B8, B8, B2;
  7. MSM stages: the harness's CLI, `python -m
     zkpoa_tpu_torch.experiments.msm_stages 20 c`, in process through
     `main`, for c = 11 (the main path's window) and c = 13 (the JAX
     harness's): every stage of a G1 MSM over 2^20 points P_i = g_i G
     timed, its piece count and combine depth, the gather kernels E1-E3
     raced against index_select, the MSM total exact; its JSON goes to
     build/chip_smoke/msm_stages.json. Then
     E1-E3 against the plain version (exact equality) at the harness's
     shapes (its GATHER_KERNELS: E1 [2^11, 16] 2^15 rows; E2 [2^11, 16]
     2^13 rows, [2^13, 16] 2^13 rows, the JAX harness's, and [2^13, 16]
     2^20 rows; E3 [2^18, 128] 2^14 rows, the TPU's, and [2^20, 16] 2^20
     rows, the MSM's), each with its bound (bytes M W 4 written, 4 M of
     indices and D W 4 read for the D distinct rows indexed) and, for the
     kernel and for index_select (the plain version, so also the library
     call), three times a call: `ms` (CUDA events around GATHER_REPS
     back-to-back calls: the larger of the host's launch path and the
     card's time), `host_ms` (the enqueue alone, host clock) and
     `device_ms`: torch.profiler's kernel time over the same calls where
     it kept at least GATHER_KEPT of the kernel records (kernels a call
     from the launch counts), else `graph_ms`, CUDA events around a CUDA
     graph replay of the calls, which every row reports beside it; the
     row's `device_method` says which. Device times are taken after every
     call time, since a profiler session may leave later launches slower.
     The kernels line carries device_ms and library_device_ms for E1-E3.
     The c = 11 run's whole-MSM stage is
     the G1 MSM at 2^20 in Mpoints/s. The launch counts of phases 4, 5, 5b, 7, 10 and 11 (each reset
     just before it) must together be non-zero for every kernel of a path;
     B2-B4 run on the path inside heavy_rounds, msm_horner, point_fold and
     scalar_mul, the elementwise G1 point_add_affine on phase 10's h-query,
     and the elementwise G2 point_add_affine, point_add and point_double,
     which no path calls any more, are checked in phase 3 only (so marked
     in the kernels line);
  10. ceremony (run after phase 7; the launch counts of its workflow join
     those of phases 4, 5, 5b and 7): write_dev_ptau(power=21) into
     build/chip_smoke/ (B8 for every section; the file's size and the
     seconds of write, read_ptau and verify_ptau's host pairings); then
     lagrange_g1 and _lagrange_g2 at 2^21 (the group NTT, K2 a stage and
     K1 for the 1/m scale, never seeing tau) must equal L_i(tau) G1 and
     L_i(tau) G2 from the seed's tau (`_lagrange_at_tau_device` and B8) at
     all 2^21 points; then the full-mode workflow with --ptau --contribute
     --beacon: root, balance sum 657 and the 13 layer-three values as the
     recorded run's, every proof verified, each layer's ceremony setup
     split (read, G1 Lagrange x3, G2 Lagrange, wire points: scale and sum,
     h-query, affine conversions, contribute, beacon) and the entry counts
     of its A, B, C printed; then layer one's phase-1 key from the
     ceremony: its proof verifies under its own vk, is rejected under the
     contributed vk, and contribute + beacon of it give the workflow's vk;
     then `export --zkey` of layer one and `prove-zkey` from the .zkey and
     .wtns (its proof verified under the .zkey's vk), with the seconds of
     each; then K1 (G1 2^16 lanes, G2 2^14; a scalar a lane, and one
     scalar for every lane) and K2 (the top stage of a 2^16 G1 / 2^14 G2
     NTT and the half = 1 stage) against their plain versions, every lane,
     exact limbs, each with its bound from this run's scalars
     (`ladder_products`: a doubling a bit below the top one and the adds
     of the best signed window, the same count whatever ladder runs) and
     its share of it, and the same kernels at the shapes layer one's
     ceremony setup gives them: K2's top and half = 1 stages over 3 x 2^21
     G1 and 2^21 G2 points, K1's 1/m scale (one scalar) over their outputs
     and K1 over layer one's wire entries of coefficient other than +-1
     (G1 A, B and the C-side sum; G2 B; ordered by coefficient), each
     launched at full size with 4096 of its lanes or butterflies held; the
     ladders of all of a group's checks run in one plain call (its time is
     each check's plain_ms); then the h-query's mixed add (B2) at all
     2^21 - 1 points;
  11. batch and multi-GPU (run after phase 10; the launch counts of its
     path join those of phases 4, 5, 5b, 7 and 10), in a one-rank NCCL
     process group (a file store under build/chip_smoke/, destroyed at the
     end): first the NTT pass kernel at the batched shapes of these paths
     against `ntt_passes_plain`, exact, each with its bound (n/2 log n
     products a transform, and n for an inverse's scale, times the batch):
     [2, 2^21] forward and inverse (prove_batched's stacked operands),
     [2^11, 2^10] and [2^10, 2^11] forward and inverse (the four-step's
     local transforms at 2^21), and the single 2^21 transform re-timed;
     then the two signatures of build/recursive_run2/sigs.json as two
     1-signature layer-one witnesses (1,390,452 constraints, 2^21) under
     one key, proved by sequential `prove` with seeds f"{seed}-b{i}" and,
     with the counts reset, by `parallel.batch_prove.prove_batched` on a
     one-rank "batch" mesh: the proofs byte-identical and verified by the
     host verifier, one NTT pass launch a pass for both witnesses, the
     wall and peak device memory of both routes; `parallel.ntt_dist
     .quotient_dist` at 2^21 on a one-rank "data" mesh, equal limbs to
     `ops.ntt.quotient`, both timed; `parallel.mesh.msm_sharded` over
     2^20 G1 points and `msm_batch_sharded` over two batches of them on a
     (1, 1) mesh, each exactly (sum s_i g_i mod r) G; Keccak:
     `ops.keccak.eth_addresses_batch` of 2^16 random 64-byte public keys on
     the card equal to the CPU run of the same function, 2^10 of them to
     the host `eth_address`, and the two recorded signers' addresses (from
     the port's fixture keys, `write_fixtures(2, extra=11)`'s) found in
     build/recursive_run2's anonymity set, with its wall and the device
     time of the batched hash;
  8. Merkle: a tree over 2^20 leaves (height 21) from numpy seed 0, timed,
     4 random leaves and their proofs checked with the host Poseidon;
  9. profile: one more layer-one key under torch.profiler (the setup
     profile: wall, device busy, B8's device ms, launches and bound from
     the chunks' non-zero digits, and the B1 launches and device ms of the
     Jacobian-to-affine conversion of each chunk, each conversion and B8
     call in a range entered and left after a synchronize), then three
     proofs, the last under torch.profiler; prints its wall time, the
     device's busy time as the union of kernel, memcpy and memset
     intervals, the idle share, the phase ends, the kernels by device time,
     each launch's time of the MSM kernels (B5/B6 pieces and combine, B7),
     every point and chain kernel's device ms and launches (the rounds,
     msm_horner, point_fold, B5-B7), the prove's launch counts and its MSM
     copies to the host, the quotient phase's host clock, device time by
     kind (NTT passes, B1, other kernels, copies) and launches (a profiler
     range per prove phase), the gathers and copies (index gathers, cat and
     copy kernels, memcpys), and the peak device memory. It fails unless
     the prove launched Horner twice (G1, G2), the rounds kernel once a
     group and the elementwise B2 never, the fold at most four times,
     copied MSM results to the host at most twice, launched the NTT pass
     kernel at least once and at most 7 x ceil(21 / TILE_LOG) times, and
     its quotient phase at most 6 B1 kernels. Then the rounds kernel is
     held against its plain version at the prove's own heavy segments,
     with the bound from the entries they add. The trace goes to
     build/chip_smoke/prove_trace.json.
The second-to-last line is a JSON object listing every kernel (its
numbers from its first check; `checks` lists every check of it, by shape);
the last is {"ok": true, "device": {...}}. Any failure exits non-zero
before them.

    python3 chip_smoke.py --setup-profile ROOT

runs only the setup profile of phase 9, on the zkpoa_tpu_torch package of
the checkout at ROOT (this tree's, or a parent's unpacked with git
archive), and prints it as one JSON line: an A/B of setup on one card.

    python3 chip_smoke.py --gather-profile ROOT

runs only phase 7's gather rows, the same way, on the package at ROOT and
its harness's shapes: an A/B of E1-E3.

    python3 chip_smoke.py --ceremony-profile ROOT

writes a power-21 dev ceremony, times layer one's phase-1 key from it (its
split) and K1's and K2's launches at that setup's shapes, on the package
at ROOT, as that package launches them: an A/B of the ceremony path.
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
LAYER_ONE_LOG_DOMAIN = 21  # its QAP domain, the size of every NTT of its prove
LAYER_TWO_LOG_DOMAIN = 23  # the recursive layer two's (phase 5b)
QUOTIENT_B1_MAX = 6  # B1 launches the quotient phase keeps: to_mont x 3, A*B, - C, from_mont
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
    "ntt_pass": ("csrc/ntt.cu", "zkpoa_tpu/ops/pallas_field.py:297"),
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
    "msm_horner_g1": ("csrc/msm_horner.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "msm_horner_g2": ("csrc/msm_horner.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_fold_g1": ("csrc/point_fold.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "point_fold_g2": ("csrc/point_fold.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "fixed_base_g1": ("csrc/fixed_base.cu", "zkpoa_tpu/ops/curve_jax.py:369"),
    "fixed_base_g2": ("csrc/fixed_base.cu", "zkpoa_tpu/ops/curve_jax.py:369"),
    "heavy_rounds_g1": ("csrc/heavy_rounds.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "heavy_rounds_g2": ("csrc/heavy_rounds.cu", "zkpoa_tpu/ops/pallas_field.py:321"),
    "gather_rows": ("csrc/gather.cu", "experiments/msm_stages.py:91"),
    "gather_vec": ("csrc/gather.cu", "experiments/msm_stages.py:110"),
    "gather_async": ("csrc/gather.cu", "experiments/msm_stages.py:150"),
    "scalar_mul_g1": ("csrc/scalar_mul.cu", "zkpoa_tpu/ops/curve_jax.py:264"),
    "scalar_mul_g2": ("csrc/scalar_mul.cu", "zkpoa_tpu/ops/curve_jax.py:264"),
    "group_ntt_stage_g1": ("csrc/scalar_mul.cu", "zkpoa_tpu/prover/ptau.py:190"),
    "group_ntt_stage_g2": ("csrc/scalar_mul.cu", "zkpoa_tpu/prover/ptau.py:190"),
}
# The elementwise B2-B4 that no path calls since Horner, the heavy-value
# fold (B3/B4) and the heavy-value rounds (B2) have kernels of their own:
# held against their plain versions in phase 3 only. B2-B4 run on the paths
# inside heavy_rounds, msm_horner, point_fold and scalar_mul, and the
# elementwise G1 mixed add (B2) on the ceremony path's h-query (phase 10).
PHASE3_ONLY = {"point_add_g1", "point_add_g2", "point_double_g1", "point_double_g2",
               "point_add_affine_g2"}
# Heavy runs of phase 3's rounds check (entries of each of 8 heavy values),
# shaped like a warm layer-one prove's: the widest takes 9 rounds of 2^16
# lanes (9 B2 launches a group before the rounds kernel)
HEAVY_RUNS = (560_000, 70_000, 20_000, 6_000, 2_000, 1_200, 600, 300)
HEAVY_PAD = 3  # a prefix pad for the c table, as the c-query has one (n_public + 1)

GATHER_REPS = 100  # back-to-back calls of each gather timing
# the least share of a gather's kernel records that torch.profiler must keep
# for its device time to stand; below it, the time of a CUDA graph replay
GATHER_KEPT = 0.9

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
# Dependent Montgomery products on a formula's critical path (curve.cuh):
# dbl-2009-l {X^2, Y^2, YZ} -> {B^2, (X + B)^2, E^2} -> {E (D - X3)}; the
# unified add {Z1^2, Z2^2, Y1 Z2, Y2 Z1, Z1 Z2} -> {U1, U2, S1, S2} ->
# {H^2, R^2, Z1Z2 H} -> {H HH, U1 HH} -> {R (V - X3), S1 HHH}. The same in
# G2, whose Fq2 product is three independent Fq products.
CHAIN = {"double": 3, "add": 5}


def reduce_chain(nb: int, threads: int) -> int:
    """Products on B7's critical path for one window (csrc/msm_reduce.cu):
    L = nb / T buckets a thread, the running sum's L - 1 adds (the first
    adds to infinity), log2 T scan adds, log2 L doublings, one add of tot,
    log2 T tree adds."""
    seg = nb // threads
    log_t, log_seg = threads.bit_length() - 1, seg.bit_length() - 1
    return CHAIN["add"] * (seg + 2 * log_t) + CHAIN["double"] * log_seg


def horner_work(c: int):
    """(doublings, adds) of Horner over the windows of one MSM at c."""
    from zkpoa_tpu_torch.ops import msm as M

    wins = M.windows(c)
    return sum(width for _off, width, _signed in wins[:-1]), len(wins) - 1


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


def once_ms(torch, fn):
    """(result, device time in ms) of one call of fn, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
        self.mont_latency_ms = None  # one Fq product's latency (mont_latency)

    def record(self, name, got, want, fn_kernel, fn_plain, work, reps=20, plain_reps=1,
               plain_is_library=False, chain=None, plain_ms=None):
        """work = (bytes, int32 operations) of one call, for its bound;
        plain_is_library: fn_plain is one PyTorch call computing the same
        function, so its time is also the library time (else there is none);
        chain: the dependent Montgomery products on the kernel's critical
        path, for its latency bound (chain x one product's latency);
        plain_ms: the plain version's time from the one call that gave
        `want` (`once_ms`), where timing more calls would cost too long."""
        err = max_abs_err(self.torch, got, want)
        ms = time_ms(self.torch, fn_kernel, reps)
        if plain_ms is None:
            plain_ms = time_ms(self.torch, fn_plain, plain_reps)
        library_ms = plain_ms if plain_is_library else None
        bound_ms, bound_by = bound(*work)
        self.rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        lat = ""
        if chain is not None:
            self.rows[name]["latency_bound_ms"] = chain * self.mont_latency_ms
            lat = f", latency bound {chain * self.mont_latency_ms:.4f} ms ({chain} products)"
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"{name}: max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {work[0]:.4g} B, {work[1]:.4g} int32 ops; "
            f"share {bound_ms / ms:.1%}){lat}")
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version")


def rand_field(torch, spec, n, gen, shape=()):
    """n random canonical elements (top limb below p's top limb) [n, *shape, 8]."""
    limbs = torch.randint(-(2**31), 2**31, (n,) + tuple(shape) + (8,), generator=gen,
                          dtype=torch.int64, device="cuda")
    top = spec.modulus >> 224
    limbs[..., 7] = torch.randint(0, top, (n,) + tuple(shape), generator=gen, device="cuda")
    return limbs.to(torch.int32)


def field_edges(modulus: int):
    """Canonical carry-heavy values: 0, 1, 2, p - 1, p - 2, (p -+ 1) / 2
    (pairs summing just under, to and just over p), values of k limbs of
    0xffffffff below p, p - 2^32 and 2^255 mod p; and operands that are not
    canonical but keep a product inside the contract a.b < 2^256 p."""
    canon = [0, 1, 2, modulus - 1, modulus - 2, (modulus - 1) // 2, (modulus + 1) // 2,
             modulus - (1 << 32), (1 << 255) % modulus]
    canon += [(1 << (32 * k)) - 1 for k in range(1, 8)]
    wide = [(1 << 256) - 1, (1 << 256) - modulus, modulus, modulus + 1, 2 * modulus - 1,
            1 << 255, (1 << 256) - (1 << 224)]
    return canon, wide


def check_field(torch, checks, gen):
    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.ops import field_kernels as FK
    from zkpoa_tpu_torch.ops import limbs as L

    def lim(vals):
        return torch.from_numpy(host.scalars_to_limbs_fast(vals)).to("cuda")

    n = 1 << 20
    for spec in (L.BN254_FQ, L.BN254_FR):
        p = spec.modulus
        canon, wide = field_edges(p)
        pairs = [(x, y) for x in canon for y in canon]  # a - b = 0, a < b, a + b around p
        a = torch.cat([rand_field(torch, spec, n, gen), lim([x for x, _ in pairs])])
        b = torch.cat([rand_field(torch, spec, n, gen), lim([y for _, y in pairs])])
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
        # the edge pairs against host integers
        rinv = pow(1 << 256, -1, p)
        ea, eb = a[n:], b[n:]
        for op, fn in ((FK.OP_MUL, lambda x, y: x * y * rinv % p),
                       (FK.OP_ADD, lambda x, y: (x + y) % p),
                       (FK.OP_SUB, lambda x, y: (x - y) % p)):
            if spec.from_limbs(FK.field_binop(spec, op, ea, eb)) != [fn(x, y) for x, y in pairs]:
                fail(f"field op {op}[{tag}] disagrees with host integers on the edge cases")
        # products with one operand not canonical, inside a.b < 2^256 p, both orders
        wp = [(x, y) for x in wide for y in canon + wide if x * y < (p << 256)]
        wp += [(y, x) for x, y in wp]
        wa, wb = lim([x for x, _ in wp]), lim([y for _, y in wp])
        got = FK.field_binop(spec, FK.OP_MUL, wa, wb)
        if not torch.equal(got, L.mont_mul_plain(spec, wa, wb)) or spec.from_limbs(got) != [
                x * y * rinv % p for x, y in wp]:
            fail(f"mont_mul[{tag}] is wrong on operands that are not canonical")
        log(f"field ops[{tag}]: {len(pairs)} edge pairs and {len(wp)} products with a "
            f"non-canonical operand exact against host integers")


def ntt_b1_stages(x, inverse):
    """The per-stage route of the NTT through elementwise B1 launches (the
    port's transform before the pass kernel), kept here as the pass
    kernel's yardstick: per stage one mont_mul of the odd half by the stage
    twiddles, an add and a sub, two copies and a stack."""
    import torch

    from zkpoa_tpu_torch.fields.bn254 import R
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import ntt as N

    spec = L.BN254_FR
    n = x.shape[0]
    log_n = n.bit_length() - 1
    x = x[N._bitrev(log_n, x.device)]
    big = N._twiddles(log_n, inverse, x.device)
    for s in range(log_n):
        half = 1 << s
        tw = big[:: n // (2 * half)]
        xb = x.view(n // (2 * half), 2, half, 8)
        u = xb[:, 0]
        v = L.mont_mul(spec, xb[:, 1].contiguous(), tw.contiguous())
        x = torch.stack([L.add_mod(spec, u, v), L.sub_mod(spec, u, v)], dim=1).view(n, 8)
    if inverse:
        x = L.mont_mul(spec, x, spec.encode([pow(n, -1, R)], x.device))
    return x


def check_ntt(torch, checks, gen, log_n):
    """The pass kernel at the main path's domain, forward and inverse (1/n
    in its last pass), against the per-stage plain version; the per-stage
    B1 route timed beside it. Bound: n/2 log_n products (+ n for 1/n) of
    256 int32 operations against the input, output and twiddle bytes."""
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import ntt as N

    n = 1 << log_n
    x = rand_field(torch, L.BN254_FR, n, gen)
    out = {}
    for inverse in (False, True):
        kern = lambda: N.ntt(x, inverse)  # noqa: E731
        plain = lambda: N.ntt_plain(x, inverse)  # noqa: E731
        got = kern()
        products = n // 2 * log_n + (n if inverse else 0)
        name = f"ntt_pass[2^{log_n} {'inv' if inverse else 'fwd'}, t={N.TILE_LOG}]"
        checks.record(name, got, plain(), kern, plain,
                      (2 * 32 * n + 32 * n // 2, products * MONT_OPS), reps=10)
        stages = lambda: ntt_b1_stages(x, inverse)  # noqa: E731
        if not torch.equal(stages(), got):
            fail(f"{name}: the per-stage B1 route disagrees with the pass kernel")
        b1_ms = time_ms(torch, stages, 5)
        checks.rows[name]["b1_stages_ms"] = b1_ms
        out["inv" if inverse else "fwd"] = {"ms": checks.rows[name]["ms"], "b1_stages_ms": b1_ms,
                                            "passes": len(N.ntt_passes(log_n, N.TILE_LOG))}
        log(f"{name}: per-stage B1 route {b1_ms:.4f} ms ({3 * log_n + (1 if inverse else 0)} "
            f"B1 launches); passes {out['inv' if inverse else 'fwd']['passes']}")
    return out


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


def mont_latency(torch, checks, gen) -> float:
    """One Fq Montgomery product's latency on the card, ms: a one-thread
    chain of 2^16 dependent products (the probe is first held against the
    same chain of plain products)."""
    from zkpoa_tpu_torch.ops import field_kernels as FK
    from zkpoa_tpu_torch.ops import limbs as L

    a = rand_field(torch, L.BN254_FQ, 2, gen)
    x = a[0]
    for _ in range(64):
        x = L.mont_mul_plain(L.BN254_FQ, x, a[1])
    if not torch.equal(FK.mont_chain(a[0], a[1], 64), x):
        fail("the Montgomery chain probe disagrees with its plain version")
    steps = 1 << 16
    ms = time_ms(torch, lambda: FK.mont_chain(a[0], a[1], steps), 3)
    checks.mont_latency_ms = ms / steps
    log(f"Montgomery product latency: {ms / steps * 1e6:.1f} ns (one thread, a chain of "
        f"{steps} dependent Fq products in {ms:.3f} ms)")
    return ms / steps


def fixed_base_b2_loop(ops, base, scalars, n_bits):
    """The B2-loop route of fixed-base multiplication on the card (setup's
    route before B8), kept here as a yardstick for B8: one gather and one
    B2 launch per 8-bit window."""
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops.curve import FB_WINDOW, fixed_base_device_table

    xs_t, ys_t, valid_t = fixed_base_device_table(ops, base, n_bits, scalars.device)
    sc = L.u32(scalars)
    acc = ops.infinity((scalars.shape[0],), scalars.device)
    for j in range((n_bits + FB_WINDOW - 1) // FB_WINDOW):
        limb, sh = divmod(j * FB_WINDOW, 32)
        idx = (sc[:, limb] >> sh) & ((1 << FB_WINDOW) - 1)
        acc = ops.add_affine(acc, xs_t[j][idx], ys_t[j][idx], valid_t[j][idx])
    return acc


def check_fixed_base(torch, checks):
    """B8 against its plain version at setup's 254 bits: G1 at 2^16 and G2
    at 2^14 (three threads a scalar: one wave) and 2^16 scalars (a thread a
    scalar), edge cases first; a few decoded against the host."""
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
    for curve, log_n in ((BN254_G1, 16), (BN254_G2, 14), (BN254_G2, 16)):
        n, g, base = 1 << log_n, curve.group, curve.generator
        name = f"fixed_base_g{g}" + ("[2^16]" if (g, log_n) == (2, 16) else "")
        scal = edge + [int.from_bytes(rng.bytes(32), "big") % r for _ in range(n - len(edge))]
        sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
        tab = fixed_base_device_table(curve, base, 254, sc.device)
        kern = lambda: fixed_base_mul_batch(curve, base, sc, 254)  # noqa: E731
        plain = lambda: fixed_base_plain(curve, *tab, sc, 254)  # noqa: E731
        got = kern()
        nwin = (254 + FB_WINDOW - 1) // FB_WINDOW
        digits = sum(1 for k in scal for j in range(nwin) if (k >> (FB_WINDOW * j)) & 255)
        cb = COORD_BYTES[g]
        work = (nwin * 256 * (2 * cb + 1) + n * (32 + 3 * cb),
                digits * PRODUCTS["add_affine"][g] * MONT_OPS)
        checks.record(name, got, plain(), kern, plain, work, reps=5)
        pick = list(range(len(edge))) + [len(edge), n - 1]
        dec = curve.decode_jac(tuple(t[pick] for t in got))
        if dec != [curve.host_mul(base, scal[i]) for i in pick]:
            fail(f"{name} disagrees with host scalar multiplication")
        b2 = time_ms(torch, lambda: fixed_base_b2_loop(curve, base, sc, 254), 3)
        out[f"g{g}_2^{log_n}"] = {"n": n, "b8_ms": checks.rows[name]["ms"], "b2_loop_ms": b2}
        log(f"fixed_base_g{g} at 2^{log_n}: host decode of {len(pick)} points exact; "
            f"B2-loop route {b2:.3f} ms")
    return out


def rounds_b2_route(curve, segments, width):
    """The heavy-value rounds as the port ran them before the rounds kernel
    (`tree_sum_many` without its fold), kept here as the kernel's
    yardstick: the segments' rows gathered and padded to whole rounds,
    then per round one B2 launch over every segment that has entries, the
    lane array re-concatenated around it. Returns lanes [S * width] in
    segment order."""
    import torch

    counts = [int(idx.shape[0]) if table.xs.shape[0] else 0 for table, idx, _off in segments]
    rounds = [-(-m // width) for m in counts]
    order = sorted(range(len(segments)), key=lambda k: -rounds[k])
    gathered = []
    for k in order[: sum(1 for r in rounds if r)]:
        table, idx, off = segments[k]
        rows = idx.to(torch.int64) - off
        ok = (rows >= 0) & (rows < table.xs.shape[0])
        rows = torch.where(ok, rows, 0)
        ok &= table.valid[rows]
        pad = rounds[k] * width - counts[k]
        rows = torch.cat([rows, rows.new_zeros(pad)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
        gathered.append((table.xs[rows], table.ys[rows], ok))
    acc = curve.infinity((len(segments) * width,), segments[0][1].device)
    for r in range(max(rounds)):
        act = sum(1 for k in order if rounds[k] > r)
        sl = slice(r * width, (r + 1) * width)
        xq, yq, ok = (torch.cat([g[i][sl] for g in gathered[:act]]) for i in range(3))
        new = curve.add_affine(tuple(t[: act * width] for t in acc), xq, yq, ok)
        if act < len(segments):
            new = tuple(torch.cat([a, t[act * width :]]) for a, t in zip(new, acc))
        acc = new
    back = sorted(range(len(order)), key=lambda i: order[i])
    return tuple(t.view((len(segments), width) + t.shape[1:])[back].view(t.shape) for t in acc)


class _Rows:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def check_heavy_rounds(torch, checks, gen):
    """The heavy-value rounds kernel against its plain version at a warm
    layer-one prove's shape: G1 over three tables (the third a suffix of the
    second at a prefix pad, as the c-query), G2 over one, each with the
    HEAVY_RUNS index runs (sorted distinct scalar indices, some past the
    table); 2^16 lanes a segment, the widest run 9 rounds. Random
    coordinates with one row in a thousand not valid; lane 0 of the widest
    run adds one row twice (P == Q), lane 1 a row and its negation
    (P == -Q). The B2 rounds route (a B2 launch a round) must give the same
    lanes and is timed beside the kernel. Bound: the entries this run adds
    (rows present), each an index, a row and a mixed add, and the lanes
    written."""
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import msm as M
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    n, width = LAYER_ONE_WIRES, M.TREE_BLOCK
    out = {}
    for curve, n_tab in ((BN254_G1, 3), (BN254_G2, 1)):
        g = curve.group
        shape = curve.coord_shape[:-1]
        runs = [torch.randperm(n + 64, generator=gen, device="cuda")[:m].sort().values
                for m in HEAVY_RUNS]
        wide = runs[0]
        wide[width] = wide[0]  # lane 0: the same row twice
        base = []
        for k in range(min(n_tab, 2)):
            xs = rand_field(torch, curve.field, n, gen, shape)
            ys = rand_field(torch, curve.field, n, gen, shape)
            valid = torch.rand(n, generator=gen, device="cuda") > 1e-3
            r1, r2 = int(wide[1]), int(wide[width + 1])  # lane 1: a row, then its negation
            if r1 < n and r2 < n:
                xs[r2] = xs[r1]
                ys[r2] = L.sub_mod_plain(curve.field, torch.zeros_like(ys[r1]), ys[r1])
                valid[r1] = valid[r2] = True
            base.append(_Rows(xs, ys, valid))
        tables = base if n_tab == 1 else base + [
            _Rows(base[1].xs[HEAVY_PAD:], base[1].ys[HEAVY_PAD:], base[1].valid[HEAVY_PAD:])]
        segments = [(t, idx, HEAVY_PAD if k == 2 else 0)
                    for k, t in enumerate(tables) for idx in runs]
        kern = lambda: M.heavy_rounds(curve, segments, width)  # noqa: E731
        plain = lambda: M.heavy_rounds_plain(curve, segments, width)  # noqa: E731
        got = kern()
        b2 = rounds_b2_route(curve, segments, width)
        if max_abs_err(torch, got, b2) != 0:
            fail(f"heavy_rounds_g{g}: the rounds kernel disagrees with the B2 rounds route")
        entries, added, n_bytes, n_ops = rounds_work(torch, curve, segments, width)
        name = f"heavy_rounds_g{g}[{len(segments)} x 2^16 lanes]"
        checks.record(name, got, plain(), kern, plain, (n_bytes, n_ops), reps=10)
        b2_ms = time_ms(torch, lambda: rounds_b2_route(curve, segments, width), 5)
        rounds = -(-max(HEAVY_RUNS) // width)
        checks.rows[name]["b2_rounds_ms"] = b2_ms
        out[f"g{g}"] = {"segments": len(segments), "entries": entries, "added": added,
                        "rounds": rounds, "ms": checks.rows[name]["ms"], "b2_rounds_ms": b2_ms}
        log(f"{name}: {entries} entries, {added} added; the B2 rounds route ({rounds} B2 launches, "
            f"gathers and concatenations) {b2_ms:.4f} ms, equal lanes")
        del segments, tables, base, runs, got, b2
    return out


def rounds_work(torch, curve, segments, width):
    """(entries, entries added, bytes, int32 operations) of the rounds over
    these segments: an index read per entry, a row (x, y, valid) and a
    mixed add per entry present, every lane written once."""
    added = 0
    for t, idx, off in segments:
        rows = idx - off
        ok = (rows >= 0) & (rows < t.xs.shape[0])
        added += int((ok & t.valid[torch.where(ok, rows, 0)]).sum())
    entries = sum(int(idx.shape[0]) for _t, idx, _o in segments)
    cb = COORD_BYTES[curve.group]
    return (entries, added, 8 * entries + added * (2 * cb + 1) + 3 * cb * len(segments) * width,
            added * PRODUCTS["add_affine"][curve.group] * MONT_OPS)


def check_prove_rounds(torch, checks, pk, witness, label="prove"):
    """The rounds kernel at a prove's own segments (phase 9 after a warm
    layer-one prove, phase 5b after the recursive layer two's; `label`
    names the rows): the witness plan's heavy values over the a, b1 and c
    tables (the c-query at its prefix pad) and over b2, as `prove` passes
    them to `msm_many`; against its plain version, with the bound from the
    entries these segments add."""
    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.ops import msm as M
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    w = torch.from_numpy(host.witness_limbs(witness)[0]).to("cuda")
    heavy, _mask = M._heavy_split(w)
    pads = ((pk.a_query, 0), (pk.b1_query, 0), (pk.c_query, pk.n_public + 1))
    out = {"heavy_counts": [int(sel.shape[0]) for _v, sel in heavy]}
    if not heavy:
        fail(f"the {label} witness has no heavy values: the prove ran no rounds")
    for curve, segments in ((BN254_G1, [(t, sel, pad) for t, pad in pads for _v, sel in heavy]),
                            (BN254_G2, [(pk.b2_query, sel, 0) for _v, sel in heavy])):
        counts = [int(idx.shape[0]) for _t, idx, _o in segments]
        width = min(M.TREE_BLOCK, 1 << max(max(counts) - 1, 0).bit_length())
        entries, added, n_bytes, n_ops = rounds_work(torch, curve, segments, width)
        kern = lambda: M.heavy_rounds(curve, segments, width)  # noqa: E731
        plain = lambda: M.heavy_rounds_plain(curve, segments, width)  # noqa: E731
        name = f"heavy_rounds_g{curve.group}[{label}: {len(segments)} segments]"
        checks.record(name, kern(), plain(), kern, plain, (n_bytes, n_ops), reps=10)
        out[f"g{curve.group}"] = {"segments": len(segments), "width": width, "entries": entries,
                                  "added": added, "rounds": -(-max(counts) // width),
                                  **checks.rows[name]}
        log(f"{name}: {entries} entries, {added} added, {width} lanes a segment, "
            f"{-(-max(counts) // width)} rounds")
    log(f"heavy values of the {label}: {len(heavy)}, entries {out['heavy_counts']}")
    return out


def accum_work(plan, n_rows, group):
    """(bytes, int32 operations) of B5/B6 over a plan: every table row read
    (x, y, valid), the plan's order and piece table, the bucket sums
    written; one mixed add per entry in some bucket."""
    cb = COORD_BYTES[group]
    lanes = plan.nw * plan.nb
    adds = int(plan.starts[:, -1].sum())
    piece_bytes = 8 * plan.n_pieces + 4 * (lanes + 1)
    return (n_rows * (2 * cb + 1) + 4 * plan.nw * plan.n + piece_bytes + 3 * cb * lanes,
            adds * PRODUCTS["add_affine"][group] * MONT_OPS)


def check_prove_accum(torch, checks, gen, pk, witness, label):
    """B5/B6 at the shapes of a prove of this key (phase 5b): G2 over the
    witness plan (heavy values split, as `prove` plans it) with the
    b2-query, G1 over a plan of dense random scalars as many as the
    h-query's rows at the h MSM's window, with the h-query; each against its
    plain version, run once and timed by that run."""
    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.experiments.msm_stages import most_pieces
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import msm as M
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    w = torch.from_numpy(host.witness_limbs(witness)[0]).to("cuda")
    n_h = len(pk.h_query)
    h = rand_field(torch, L.BN254_FR, n_h, gen)
    out = {}
    for curve, table, plan in (
            (BN254_G2, pk.b2_query, M.plan_msm(w)),
            (BN254_G1, pk.h_query, M.plan_msm(h, M.auto_c(n_h), split_heavy=False))):
        g = curve.group
        kern = lambda: M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan)  # noqa: E731
        plain = lambda: M.accumulate_plain(  # noqa: E731
            curve, table.xs, table.ys, table.valid, 0, plan)
        got = kern()
        want, plain_ms = once_ms(torch, plain)
        name = f"msm_accum_g{g}[{label}: {plan.n} scalars]"
        checks.record(name, got, want, kern, plain, accum_work(plan, table.xs.shape[0], g),
                      reps=3, plain_ms=plain_ms)
        out[f"g{g}"] = {"scalars": plan.n, "c": plan.c, "pieces": plan.n_pieces,
                        "max_pieces": most_pieces(plan), "combine_depth": plan.combine_depth,
                        **checks.rows[name]}
        log(f"{name}: {plan.n} scalars, c = {plan.c}, {plan.n_pieces} pieces, at most "
            f"{most_pieces(plan)} a bucket, combine depth {plan.combine_depth}")
        del got, want, plan
    return out


def check_msm(torch, checks, gen):
    import numpy as np

    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.experiments.msm_stages import fixed_base_points, most_pieces
    from zkpoa_tpu_torch.fields import bn254
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import msm as M
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2

    rng = np.random.default_rng(0)
    c = M.auto_c(LAYER_ONE_WIRES)  # the window size of every MSM of the main path
    for curve, log_n in ((BN254_G1, 16), (BN254_G2, 14)):
        n = 1 << log_n
        g = curve.group
        gens = [int(x) for x in rng.integers(1, 2**63, size=n, dtype=np.uint64)]
        table = fixed_base_points(curve, gens, "cuda")
        scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
        sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
        plan = M.plan_msm(sc, c, split_heavy=False)
        acc = lambda: M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan)  # noqa: E731
        acc_plain = lambda: M.accumulate_plain(  # noqa: E731
            curve, table.xs, table.ys, table.valid, 0, plan)
        buckets = acc()
        cb = COORD_BYTES[g]
        lanes = plan.nw * plan.nb
        checks.record(f"msm_accum_g{g}", buckets, acc_plain(), acc, acc_plain,
                      accum_work(plan, n, g), reps=3)
        log(f"msm_accum_g{g} at 2^{log_n}: {plan.n_pieces} pieces of at most {plan.piece} "
            f"entries, at most {most_pieces(plan)} a bucket; combine {len(plan.combine)} levels, "
            f"depth {plan.combine_depth} full adds")
        # B7 as the main path calls it: G1 over the four G1 MSMs of a prove
        # (4 x 24 windows in one launch), G2 over the one G2 MSM
        n_msm = 4 if g == 1 else 1
        parts = [buckets]
        for _ in range(n_msm - 1):
            sc_k = torch.from_numpy(host.scalars_to_limbs_fast(
                [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)])).to("cuda")
            plan_k = M.plan_msm(sc_k, c, split_heavy=False)
            parts.append(M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan_k))
        for m in sorted({n_msm, 1}, reverse=True):
            bk = tuple(torch.cat([p[k] for p in parts[:m]]) for k in range(3))
            nw = m * plan.nw
            red = lambda: M.reduce(curve, bk, nw, plan.nb)  # noqa: E731
            red_plain = lambda: M.reduce_plain(curve, bk, nw, plan.nb)  # noqa: E731
            totals = red()
            checks.record(f"msm_reduce_g{g}[{nw} windows]", totals, red_plain(), red, red_plain,
                          (3 * cb * (m * lanes + nw),
                           2 * m * lanes * PRODUCTS["add"][g] * MONT_OPS), reps=5,
                          chain=reduce_chain(plan.nb, M.reduce_threads(plan.nb)))
            if m == n_msm:
                main_totals = tuple(t.reshape((m, plan.nw) + curve.coord_shape) for t in totals)
        # Horner over those totals as the main path calls it: one launch, a warp per MSM
        hk = lambda: M.horner(curve, main_totals, c)  # noqa: E731
        hp = lambda: M.horner_plain(curve, main_totals, c)  # noqa: E731
        dbls, adds_h = horner_work(c)
        checks.record(f"msm_horner_g{g}[{n_msm} MSMs, c={c}]", hk(), hp(), hk, hp,
                      (3 * cb * n_msm * (plan.nw + 1),
                       n_msm * (dbls * PRODUCTS["double"][g] + adds_h * PRODUCTS["add"][g])
                       * MONT_OPS), reps=10,
                      chain=CHAIN["double"] * dbls + CHAIN["add"] * adds_h)
        # the heavy-value fold at the main path's shape: (a, b1, c) x 8 heavy
        # values of 2^16 lanes each in G1, b2 x 8 in G2; every lane a point
        n_seg, width = (24 if g == 1 else 8), M.TREE_BLOCK
        idx = torch.randint(0, n, (n_seg * width,), generator=gen, device="cuda")
        ar = curve.arith("cuda")
        one = L.to_i32(ar.one_like(L.u32(table.xs[:1])))
        xs_f = table.xs[idx]
        lanes_f = (xs_f, table.ys[idx], one.expand(xs_f.shape).contiguous())
        fk = lambda: M.fold(curve, lanes_f, width)  # noqa: E731
        fp = lambda: M.fold_plain(curve, lanes_f, width)  # noqa: E731
        checks.record(f"point_fold_g{g}[{n_seg} x 2^16 lanes]", fk(), fp(), fk, fp,
                      (3 * cb * n_seg * (width + 1),
                       n_seg * (width - 1) * PRODUCTS["add"][g] * MONT_OPS), reps=5,
                      chain=CHAIN["add"] * (width.bit_length() - 1))
        del lanes_f, xs_f, idx
        got = M.msm_many(curve, [(table, plan, 0)])[0]
        want = curve.host_mul(curve.generator, sum(s * k for s, k in zip(scal, gens)) % bn254.R)
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


def check_workflow_outputs(bdir, what):
    """The full-mode workflow's outputs under bdir against the recorded
    run's: Merkle root, balance sum 657, the 13 layer-three values, and
    every layer-two and layer-three proof.json verified (the workflow
    verifies each layer-one proof before it goes on). Returns the
    balances."""
    from zkpoa_tpu_torch.prover import groth16

    def load(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    if load(bdir, "merkle_root.json") != load(GOLDEN, "merkle_root.json"):
        fail(f"{what} Merkle root differs from the recorded run's")
    balances = [int(load(bdir, f"batch_{b}", "public.json")[0]) for b in range(2)]
    if sum(balances) != 657:
        fail(f"{what} balance sum {sum(balances)} (balances {balances}), expected 657")
    l3 = load(bdir, "layer_three", "public.json")
    if l3 != load(GOLDEN, "layer_three", "commitment.json") or len(l3) != 13:
        fail(f"{what} layer-three public values differ from the recorded commitment")
    proofs = [(os.path.join(bdir, f"batch_{b}"), "layer_two") for b in range(2)]
    proofs.append((os.path.join(bdir, "layer_three"), "layer_three"))
    for d, name in proofs:
        if not groth16.verify_files(os.path.join(d, f"{name}_vkey.json"),
                                    os.path.join(d, "proof.json"), os.path.join(d, "public.json")):
            fail(f"{what}: {d}/proof.json does not verify")
    return balances


def workflow_path(torch, tmp):
    """Phase 5: the full-mode workflow on the recorded run's inputs through
    the CLI's main; its outputs against the recorded ones."""
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline import workflow

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
    balances = check_workflow_outputs(bdir, "workflow")
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


def recursive_layer_two(torch, checks, gen, bdir):
    """Phase 5b: the recursive layer-two circuit of the recorded run's batch 0
    (the in-snark verifier of the workflow phase's own layer-one proof, at
    its full size), built by the workflow's own functions, set up and proved
    on the card; launch counts of this phase alone. Then, outside them, the
    rounds kernel and B5/B6 against their plain versions at this prove's
    shapes."""
    import resource

    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline import workflow
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    inp, vk1_json = workflow.load_layer_two_input(os.path.join(bdir, "batch_0"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    c2 = workflow.recursive_layer_two_circuit(inp, vk1_json, 5)
    r1cs, witness = c2.compile()
    t1 = time.perf_counter()
    pk = setup_device(r1cs, "cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peaks = {"setup": torch.cuda.max_memory_allocated()}
    phases = []

    def on_phase(msg):
        # each prove phase's own peak device memory (the plans' among them)
        name = msg.removeprefix("prove: ").rsplit(" ", 1)[0]
        peaks[name] = torch.cuda.max_memory_allocated()
        phases.append(f"{msg.removeprefix('prove: ')} (peak {peaks[name] / 2**30:.2f} GiB)")
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    proof = prove(pk, r1cs, witness, "cuda", seed="l2-b0", log=on_phase)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(_build.COUNTS)
    peak = max(peaks.values())
    publics = [str(x) for x in c2.public_values]
    ok = groth16.verify(groth16.VerifyingKey.from_json(pk.vk_json), proof, c2.public_values)
    domain = pk.domain_size
    n, wires = r1cs.n_constraints, r1cs.n_wires
    del r1cs, c2, proof
    if not ok:
        fail("recursive layer two: the host verifier refuses the proof")
    with open(os.path.join(GOLDEN, "batch_0", "public.json")) as f:
        want = json.load(f)
    if publics != want:
        fail(f"recursive layer two: public values {publics}, recorded {want}")
    if domain != 1 << 23:
        fail(f"recursive layer two: domain {domain}, expected 2^23")
    with open("/proc/meminfo") as f:
        total_kib = int(next(ln for ln in f if ln.startswith("MemTotal:")).split()[1])
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out = {"constraints": n, "wires": wires, "domain": domain, "build_s": t1 - t0,
           "setup_s": t2 - t1, "prove_s": t3 - t2, "peak_device_bytes": peak,
           "peak_rss_kib": rss_kib, "host_ram_kib": total_kib, "prove_phases": phases,
           "peak_device_bytes_by_phase": peaks}
    log(f"recursive layer two (batch 0, the in-snark verifier of the workflow's layer-one "
        f"proof): {n} constraints, {wires} wires, domain 2^{domain.bit_length() - 1}; host "
        f"build {t1 - t0:.2f} s, setup_device {t2 - t1:.2f} s, prove {t3 - t2:.2f} s; proof "
        f"verified, public values equal the recorded batch_0/public.json; peak device memory "
        f"{peak / 2**30:.2f} GiB, peak host RSS {rss_kib / 2**20:.2f} GiB of "
        f"{total_kib / 2**20:.1f} GiB")
    log("recursive layer two prove phase ends: " + "; ".join(phases))
    log(f"launches in the recursive layer-two phase: {json.dumps(counts, sort_keys=True)}")
    out["kernel_checks"] = {
        "heavy_rounds": check_prove_rounds(torch, checks, pk, witness, "layer two"),
        "msm_accum": check_prove_accum(torch, checks, gen, pk, witness, "layer two")}
    del pk, witness
    torch.cuda.empty_cache()
    return out, counts


# ---------------------------------------------------------------------------
# Phase 10: the powers-of-tau ceremony path (K1, K2)
# ---------------------------------------------------------------------------

CEREMONY_POWER = 21  # the ceremony layer one needs (2^21 domain)
CEREMONY_SEED = "zkpoa-dev-ceremony"
CONTRIBUTE, BEACON = "chip-smoke contribution", "0xbeac0n"
PATH_SAMPLE = 1 << 12  # lanes of a path-shape launch held against the plain version


def ceremony_file(torch, path):
    """Step 1: the power-21 dev ceremony written, read and verified."""
    from zkpoa_tpu_torch.prover import ptau as P

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.write_dev_ptau(path, CEREMONY_POWER, seed=CEREMONY_SEED, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pt = P.read_ptau(path, "cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok = P.verify_ptau(pt)
    t3 = time.perf_counter()
    if not ok:
        fail("verify_ptau refuses the dev ceremony")
    size = os.path.getsize(path)
    out = {"bytes": size, "write_s": t1 - t0, "read_s": t2 - t1, "verify_s": t3 - t2}
    log(f"ceremony: write_dev_ptau(power={CEREMONY_POWER}) {t1 - t0:.2f} s, {size} bytes "
        f"({size / 2**30:.3f} GiB); read_ptau {t2 - t1:.2f} s; verify_ptau (host pairings) "
        f"{t3 - t2:.2f} s: accepted")
    return pt, out


def check_lagrange(torch, pt):
    """Step 2: lagrange_g1 and _lagrange_g2 (which never see tau) at 2^21
    equal L_i(tau) G1 and L_i(tau) G2 from the seed's tau
    (`_lagrange_at_tau_device` and B8) at every index."""
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2
    from zkpoa_tpu_torch.ops.limbs import BN254_FR
    from zkpoa_tpu_torch.prover import ptau as P
    from zkpoa_tpu_torch.prover.setup import _lagrange_at_tau_device, _query_device

    m = 1 << CEREMONY_POWER
    tau = P._hash_to_fr(CEREMONY_SEED, "tau")
    got, ms = once_ms(torch, lambda: P.lagrange_g1(pt["tau_g1"], m))
    got = BN254_G1.to_affine(got)
    lag, _z = _lagrange_at_tau_device(m, tau, "cuda")
    lag = BN254_FR.from_mont(lag)
    want = _query_device(BN254_G1, lag)
    for a, b in zip(got, (want.xs, want.ys, want.valid)):
        if not torch.equal(a, b):
            fail("lagrange_g1 at 2^21 differs from L_i(tau) G1")
    del got, want
    got2, ms2 = once_ms(torch, lambda: P._lagrange_g2(pt["tau_g2"], m))
    got2 = BN254_G2.to_affine(got2)
    want2 = _query_device(BN254_G2, lag)
    for a, b in zip(got2, (want2.xs, want2.ys, want2.valid)):
        if not torch.equal(a, b):
            fail("_lagrange_g2 at 2^21 differs from L_i(tau) G2")
    out = {"g1_ms": ms, "g2_ms": ms2, "points": m}
    log(f"ceremony: lagrange_g1 ({ms / 1e3:.2f} s) and _lagrange_g2 ({ms2 / 1e3:.2f} s) at "
        f"2^21 equal L_i(tau) G1 and L_i(tau) G2 at all {m} points")
    return out


def ceremony_workflow(torch, tmp, ptau_path):
    """Step 3: the full-mode workflow with --ptau --contribute --beacon, its
    outputs against the recorded run's; launch counts of this run alone."""
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline import workflow

    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    rc = workflow.main([os.path.join(RUN2, "sigs.json"), os.path.join(RUN2, "anon.csv"), BLIND,
                        "-p", "1", "-m", "full", "--device", "cuda", "-b", tmp,
                        "--ptau", ptau_path, "--contribute", CONTRIBUTE, "--beacon", BEACON])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"ceremony workflow exited {rc}")
    bdir = os.path.join(tmp, "2_sigs_2_batches_5_height")
    check_workflow_outputs(bdir, "ceremony workflow")
    with open(os.path.join(bdir, "benchmarks.txt")) as f:
        bench = f.read()
    splits = [ln.strip() for ln in bench.splitlines() if "ceremony setup" in ln]
    if len(splits) != 3:
        fail(f"ceremony workflow: {len(splits)} ceremony setups, expected 3 (one a layer)")
    for line in bench.splitlines():
        if line.strip():
            log(f"ceremony workflow {line.strip()}")
    for k in ("scalar_mul_g1", "scalar_mul_g2", "group_ntt_stage_g1", "group_ntt_stage_g2",
              "point_add_affine_g1"):
        if counts.get(k, 0) == 0:
            fail(f"{k} was not launched by the ceremony workflow")
    log(f"ceremony workflow: wall {wall:.2f} s, root, balance sum 657 and 13 layer-three "
        f"values equal the recorded run's, every proof verified; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"launches in the ceremony workflow phase: {json.dumps(counts, sort_keys=True)}")
    return {"wall_s": wall, "peak_bytes": peak, "setup_splits": splits,
            "benchmarks": bench}, counts, bdir


def check_old_key(torch, bdir, ptau_path):
    """Step 4: layer one's phase-1 key from the ceremony, before the
    contribution: its proof verifies under its own vk and not under the
    workflow's contributed one, which contribute + beacon of it reproduce."""
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover import ptau as P
    from zkpoa_tpu_torch.prover.prove import prove

    with open(os.path.join(bdir, "batch_0", "layer_one_input.json")) as f:
        circuit, _name = cli._build_circuit("one", json.load(f), False)
    r1cs, wit = circuit.compile()
    times = {}
    t0 = time.perf_counter()
    pk0 = P.setup_from_ptau(r1cs, ptau_path, "cuda", times=times)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pk2 = P.beacon(P.contribute(pk0, CONTRIBUTE), BEACON)
    with open(os.path.join(bdir, "batch_0", "layer_one_vkey.json")) as f:
        vk_new = json.load(f)
    if json.loads(json.dumps(pk2.vk_json)) != vk_new:
        fail("contribute + beacon of layer one's phase-1 key do not give the workflow's vk")
    old = prove(pk0, r1cs, wit, "cuda", seed="old-key")
    publics = circuit.public_values
    if not groth16.verify(groth16.VerifyingKey.from_json(pk0.vk_json), old, publics):
        fail("the phase-1 key's proof does not verify under its own vk")
    if groth16.verify(groth16.VerifyingKey.from_json(vk_new), old, publics):
        fail("the phase-1 key's proof verifies under the contributed vk")
    log(f"ceremony: layer one's phase-1 key ({setup_s:.2f} s; {P.setup_split(times)}): its "
        f"proof verifies under its own vk and is rejected under the contributed vk, which "
        f"contribute + beacon of it reproduce")
    return {"setup_s": setup_s, "split": times}, r1cs


def zkey_round_trip(torch, bdir, tmp):
    """Step 5: `export --zkey` of layer one, then `prove-zkey` from the .zkey
    and .wtns, which verifies its proof under the .zkey's vk and fails
    otherwise."""
    from zkpoa_tpu_torch.prover import __main__ as cli

    out = os.path.join(tmp, "export")
    inp = os.path.join(bdir, "batch_0", "layer_one_input.json")
    t0 = time.perf_counter()
    if cli.main(["export", "--layer", "one", "--input", inp, "-o", out, "--zkey",
                 "--device", "cuda"]) != 0:
        fail("export --zkey of layer one failed")
    t1 = time.perf_counter()
    base = os.path.join(out, "layer_one_1_sigs")
    if cli.main(["prove-zkey", "--zkey", base + ".zkey", "--wtns", base + ".wtns",
                 "-o", os.path.join(out, "proof"), "--device", "cuda"]) != 0:
        fail("prove-zkey of layer one failed")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    size = os.path.getsize(base + ".zkey")
    log(f"ceremony: export --zkey of layer one {t1 - t0:.2f} s (build, setup, .r1cs, .wtns, "
        f".zkey of {size} bytes; the CLI's own seconds above), prove-zkey {t2 - t1:.2f} s "
        f"(read and prove; the proof verifies under the .zkey's vk)")
    return {"export_s": t1 - t0, "prove_zkey_s": t2 - t1, "zkey_bytes": size}


def ladder_products(torch, limbs, group, weight=None) -> int:
    """Montgomery products of the ladders [k] P over plain-limb scalars
    [N, 8] (a tensor; scalar i counted weight[i] times), by a rule that
    counts the same work whatever ladder runs: the scalar's doublings (its
    bit length - 1) and the adds of the best signed window for it, the
    width-w NAF for w in 2..6 (its non-zero digits - 1 adds, and for w > 2
    a doubling and 2^(w-2) - 1 adds for the odd multiples 3 P .. (2^(w-1)
    - 1) P); k = 0 costs nothing. A binary ladder's adds of set bits, the
    old rule, charge more than a window needs."""
    pd, pa = PRODUCTS["double"][group], PRODUCTS["add"][group]
    uniq, inv = torch.unique(limbs.reshape(-1, 8), dim=0, return_inverse=True)
    cnt = torch.zeros(len(uniq), dtype=torch.int64, device=limbs.device)
    wt = (torch.ones(len(inv), dtype=torch.int64, device=limbs.device) if weight is None
          else torch.as_tensor(weight, dtype=torch.int64, device=limbs.device))
    cnt.index_add_(0, inv, wt)
    u = uniq.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=limbs.device)
    bits = ((u[:, :, None] >> shifts) & 1).reshape(len(u), 256)
    bits = torch.cat([bits, torch.zeros_like(bits[:, :16])], dim=1)
    nz = bits.any(1)
    bitlen = 256 - torch.argmax(bits[:, :256].flip(1), dim=1)
    best = None
    for w in range(2, 7):
        win = sum(bits[:, s : s + 256 + 8] << s for s in range(1, w))
        nnz = torch.zeros_like(cnt)
        carry = torch.zeros_like(cnt)
        nxt = torch.zeros_like(cnt)
        for t in range(256 + 8):  # LSB first; a digit consumes w positions
            at = nxt == t
            b = bits[:, t] + carry
            odd, even = at & (b == 1), at & (b != 1)
            nnz += odd.to(torch.int64)
            carry = torch.where(odd, (1 + win[:, t] >= 1 << (w - 1)).to(torch.int64),
                                torch.where(even, b >> 1, carry))
            nxt = torch.where(odd, nxt + w, torch.where(even, nxt + 1, nxt))
        cost = (nnz - 1) * pa + ((pd + ((1 << (w - 2)) - 1) * pa) if w > 2 else 0)
        best = cost if best is None else torch.minimum(best, cost)
    per = torch.where(nz, (bitlen - 1) * pd + best, torch.zeros_like(best))
    return int((per * cnt).sum())


def path_sample(rng, n, k):
    """min(k, n) sorted distinct indices below n: both ends and random ones."""
    import numpy as np

    k = min(k, n)
    pick = {0, n - 1} | set(int(i) for i in rng.choice(n, max(k - 2, 0), replace=False))
    while len(pick) < k:
        pick.add(int(rng.integers(n)))
    return np.array(sorted(pick), dtype=np.int64)


def check_ladders(torch, checks, ptau_path, r1cs):
    """Step 6: K1, K2 and the elementwise G1 mixed add against their plain
    versions, exact limbs, each with its bound from this run's scalars
    (`ladder_products`):
      * test shapes, every lane: K1 over 2^16 G1 / 2^14 G2 random points,
        a scalar a lane (0, 1, 2 and r - 1 among them) and one scalar for
        every lane; K2's top stage (one block) and its half = 1 stage (2^15
        / 2^13 blocks, every twiddle 1) over 2^16 G1 / 2^14 G2 points;
      * the shapes layer one's ceremony setup gives them (2^21 domain),
        each launched at full size with PATH_SAMPLE of its lanes or
        butterflies held: K2's top and half = 1 stages over the 3 x 2^21 G1
        points of the three sources side by side and over the 2^21 G2
        points, on the domain's twiddle digits; K1's 1/m scale over the top
        stages' outputs, one scalar [8] for every lane as the path gives
        it; K1 over layer one's wire entries whose coefficient is not +-1
        (G1: those of A, B and the C-side sum; G2: those of B) at their rows
        and coefficients, ordered by coefficient as the path orders them;
      * the mixed add of the 2^21 - 1 monomial h-query points, every point.
    The plain ladder's time hardly grows with its lanes at these sizes, so
    the ladders of all of a group's K1 and K2 checks (K1's lanes, K2's
    scaled v) run in one plain call on their digits, whose time is each of
    those checks' plain_ms; K2's adds are then `butterfly_plain` on the
    same u."""
    import numpy as np

    from zkpoa_tpu_torch import host
    from zkpoa_tpu_torch.fields.bn254 import R
    from zkpoa_tpu_torch.ops import field_kernels as FK
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops.curve import (BN254_G1, booth_digits, fixed_base_mul_batch,
                                           jac_add_affine, ladder_plain, run_plain)
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2
    from zkpoa_tpu_torch.ops.group_ntt import butterfly_plain
    from zkpoa_tpu_torch.ops.limbs import BN254_FQ, BN254_FR
    from zkpoa_tpu_torch.ops.ntt import _bitrev, _twiddles
    from zkpoa_tpu_torch.prover import ptau as P

    log_m = CEREMONY_POWER
    m = 1 << log_m
    if P._domain(r1cs.n_constraints) != m:
        fail(f"layer one's domain is not 2^{log_m}")
    pt = P.read_ptau(ptau_path, "cuda", m)
    packed = r1cs.pack()
    mag, _neg, unit, zero = P._pool_split(packed.pool_limbs)
    rng = np.random.default_rng(3)
    rev = _bitrev(log_m, "cuda")
    table = BN254_FR.from_mont(_twiddles(log_m, True, "cuda"))  # w^-j, j < m/2
    digits = booth_digits(table)  # the path's: once a domain
    minv = torch.from_numpy(BN254_FR.to_limbs([pow(m, -1, R)])[0]).to("cuda")  # one [8]
    lim = lambda ks: torch.from_numpy(host.scalars_to_limbs_fast(ks)).to("cuda")  # noqa: E731
    rand = lambda k: [int.from_bytes(rng.bytes(32), "big") % R for _ in range(k)]  # noqa: E731

    def rows(x, sel):
        return x if sel is None else tuple(t[sel] for t in x) if isinstance(x, tuple) else x[sel]

    out = {}
    groups = (
        (BN254_G1, 16,
         [P._jac(BN254_G1, pt[k]) for k in ("tau_g1", "alpha_tau_g1", "beta_tau_g1")],
         [(0, packed.a), (0, packed.b), (2 * m, packed.a), (m, packed.b), (0, packed.c)]),
        (BN254_G2, 14, [P._jac(BN254_G2, pt["tau_g2"])],
         [(0, packed.b)]),
    )
    for curve, log_n, srcs, parts in groups:
        g, cb = curve.group, COORD_BYTES[curve.group]
        # (name, kernel rows, ladder points, digits, butterfly u or None, kernel fn, work, reps)
        jobs = []

        def ladder_job(name, p, sc, sel=None, weight=None):
            """K1 over every lane of p (sc: a scalar a lane, or one [8]);
            lanes sel (all when None) held; the bound from the lanes'
            scalars, weight[i] times scalar i where given."""
            got = FK.scalar_mul(g, p, sc, 254)
            n = p[0].shape[0]
            k = n if sel is None else len(sel)
            one = sc.dim() == 1
            dig = booth_digits(sc).expand(k, -1) if one else booth_digits(rows(sc, sel))
            prods = ladder_products(torch, sc, g, [n] if one else weight)
            jobs.append((name, rows(got, sel), rows(p, sel), dig, None,
                         lambda: FK.scalar_mul(g, p, sc, 254),
                         (n * 6 * cb + sc.numel() * 4, prods * MONT_OPS), 5 if sel is None else 2))

        def stage_job(name, pts, dig, tw, log_half, b, reps):
            """K2's stage over a copy of pts on the twiddles' digits dig
            (their limbs tw, for the bound); butterflies b held."""
            half, n = 1 << log_half, pts[0].shape[0]
            got = FK.group_ntt_stage(g, tuple(t.clone() for t in pts), dig, log_half)
            j = b % half
            u = (b // half) * 2 * half + j
            ui, vi, ji = (torch.from_numpy(a).to("cuda") for a in (u, u + half, j))
            prods = ladder_products(torch, tw, g, np.full(half, n // (2 * half), np.int64))
            jobs.append((name, tuple(torch.cat([t[ui], t[vi]]) for t in got),
                         rows(pts, vi), dig[ji], rows(pts, ui),
                         lambda: FK.group_ntt_stage(g, tuple(t.clone() for t in pts), dig,
                                                    log_half),
                         (n * 6 * cb + half * dig.shape[1],
                          (prods + n * PRODUCTS["add"][g]) * MONT_OPS), reps))
            return got

        # test shapes, every lane
        n = 1 << log_n
        p = tuple(t.contiguous() for t in fixed_base_mul_batch(curve, curve.generator,
                                                               lim(rand(n)), 254))
        ladder_job(f"scalar_mul_g{g}[2^{log_n} lanes]", p, lim([0, 1, 2, R - 1] + rand(n - 4)))
        ladder_job(f"scalar_mul_g{g}[2^{log_n} lanes, one scalar]", p, lim(rand(1))[0])
        for log_half in (log_n - 1, 0):
            tw = lim([1] + rand((1 << log_half) - 1))
            stage_job(f"group_ntt_stage_g{g}[2^{log_n} points, half 2^{log_half}]", p,
                      booth_digits(tw), tw, log_half, np.arange(n // 2), 5)
        # layer one's path shapes, sampled; lagrange_points's first stage
        # input: the sources bit-reversed, side by side
        pts = tuple(torch.cat([src[k][:m][rev] for src in srcs]).contiguous() for k in range(3))
        n = pts[0].shape[0]
        tag = f"{len(srcs)} x 2^{log_m}"
        for log_half in (log_m - 1, 0):
            step = m >> (log_half + 1)
            got = stage_job(f"group_ntt_stage_g{g}[{tag} points, half 2^{log_half}, "
                            f"{PATH_SAMPLE} butterflies sampled]", pts, digits[::step],
                            table[::step], log_half, path_sample(rng, n // 2, PATH_SAMPLE), 2)
            if log_half == log_m - 1:
                top = got
        del got
        sel = torch.from_numpy(path_sample(rng, n, PATH_SAMPLE)).to("cuda")
        ladder_job(f"scalar_mul_g{g}[{tag} lanes, 1/m, one scalar, {PATH_SAMPLE} sampled]", top,
                   minv, sel)
        r_idx, cid, _rank = P._scaled_entries([parts], unit, zero)  # the path's order
        k = out[f"g{g}_wire_entries"] = len(r_idx)
        if k:
            flat = tuple(torch.cat([src[c][:m] for src in srcs]) for c in range(3))
            wpts = rows(flat, torch.from_numpy(r_idx).to("cuda"))
            sel = torch.from_numpy(path_sample(rng, k, PATH_SAMPLE)).to("cuda")
            ladder_job(f"scalar_mul_g{g}[{k} lanes, layer one's wire entries, {len(sel)} "
                       "sampled]", wpts, torch.from_numpy(mag[cid]).to("cuda"), sel)
            del flat
        else:  # then the path launches no such K1 either
            log(f"ladders G{g}: layer one has no wire entry to scale")
        # one plain ladder call for every check of the group
        lanes = [len(jb[3]) for jb in jobs]
        p_all = tuple(torch.cat([jb[2][c] for jb in jobs]) for c in range(3))
        want_all, plain_ms = once_ms(torch, lambda: ladder_plain(
            curve, p_all, torch.cat([jb[3] for jb in jobs])))
        off = 0
        for (name, got, _p, _dig, u, kern, work, reps), k in zip(jobs, lanes):
            want = tuple(t[off : off + k] for t in want_all)
            off += k
            if u is not None:
                want = tuple(torch.cat(ab) for ab in zip(*butterfly_plain(curve, u, want)))
            checks.record(name, got, want, kern, None, work, reps=reps, plain_ms=plain_ms)
        log(f"ladders G{g}: one plain ladder call over the {sum(lanes)} lanes of the checks "
            f"above {plain_ms:.1f} ms (each check's plain_ms)")
        out[f"g{g}_plain_lanes"] = sum(lanes)
        del jobs, pts, top, p_all, want_all
    # the monomial h-query's elementwise mixed add (B2), at every point
    tg = pt["tau_g1"]
    hi = BN254_G1.from_affine(tg.xs[m : 2 * m - 1], tg.ys[m : 2 * m - 1], tg.valid[m : 2 * m - 1])
    args = (hi, tg.xs[: m - 1], L.neg_mod(BN254_FQ, tg.ys[: m - 1]), tg.valid[: m - 1])
    fk = lambda: FK.point_add_affine(1, *args)  # noqa: E731
    want, plain_ms = once_ms(torch, lambda: run_plain(BN254_G1.arith("cuda"), jac_add_affine,
                                                      *args))
    checks.record(f"point_add_affine_g1[2^{log_m} - 1 points, the h-query]", fk(), want, fk,
                  None, ((m - 1) * (8 * 32 + 1), PRODUCTS["add_affine"][1] * MONT_OPS * (m - 1)),
                  reps=5, plain_ms=plain_ms)
    return out


def ceremony_path(torch, checks):
    """Phase 10: the ceremony path at its real size: the power-21 dev
    ceremony, the exact Lagrange check at 2^21, the full-mode workflow with
    --ptau --contribute --beacon (launch counts of that run alone), the old
    key's proof rejected, the layer-one .zkey / .wtns round trip, then K1
    and K2 against their plain versions, at test shapes and at the path's.
    The ceremony file lives in build/chip_smoke/ and is removed at the
    end."""
    os.makedirs(OUT_DIR, exist_ok=True)
    ptau_path = os.path.join(OUT_DIR, f"dev_{CEREMONY_POWER}.ptau")
    t0 = time.perf_counter()
    try:
        pt, out = ceremony_file(torch, ptau_path)
        out["lagrange"] = check_lagrange(torch, pt)
        del pt
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            wf, counts, bdir = ceremony_workflow(torch, tmp, ptau_path)
            out["workflow"] = wf
            out["old_key"], r1cs = check_old_key(torch, bdir, ptau_path)
            torch.cuda.empty_cache()
            out["zkey"] = zkey_round_trip(torch, bdir, tmp)
        torch.cuda.empty_cache()
        out["ladders"] = check_ladders(torch, checks, ptau_path, r1cs)
    finally:
        if os.path.exists(ptau_path):
            os.remove(ptau_path)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"ceremony phase: {out['wall_s']:.1f} s")
    return out, counts


def check_ntt_batched(torch, checks, gen) -> dict:
    """Phase 11's NTT checks: the pass kernel at the batched shapes of
    prove_batched ([2, 2^21]) and of the four-step's local transforms at
    2^21 ([2^11, 2^10], [2^10, 2^11]), forward and inverse, against the
    plain pass schedule on the same inputs; the single 2^21 transform
    re-timed first. Bound: per transform n/2 log_n products (+ n for an
    inverse's 1/n) against its input and output, the twiddles once."""
    from zkpoa_tpu_torch.fields.bn254 import R
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import ntt as N

    out = {}
    for lead, log_n, dirs in (((), 21, (False,)), ((2,), 21, (False, True)),
                              ((1 << 11,), 10, (False, True)), ((1 << 10,), 11, (False, True))):
        n = 1 << log_n
        batch = lead[0] if lead else 1
        x = rand_field(torch, L.BN254_FR, batch, gen, shape=(n,)).reshape(lead + (n, 8))
        ninv = L.BN254_FR.encode([pow(n, -1, R)], "cuda")
        for inverse in dirs:
            kern = lambda: N.ntt(x, inverse)  # noqa: E731
            plain = lambda: N.ntt_passes_plain(x, inverse, ninv if inverse else None)  # noqa: E731
            products = batch * (n // 2 * log_n + (n if inverse else 0))
            name = f"ntt_pass[{batch} x 2^{log_n} {'inv' if inverse else 'fwd'}, t={N.TILE_LOG}]"
            checks.record(name, kern(), plain(), kern, plain,
                          (batch * 2 * 32 * n + 32 * n // 2, products * MONT_OPS), reps=10)
            out[name] = dict(checks.rows[name], passes=len(N.ntt_passes(log_n, N.TILE_LOG)))
    return out


def batch_multi_gpu(torch, checks, gen):
    """Phase 11: the batched NTT checks, then (counted) prove_batched,
    quotient_dist, the sharded MSMs and the batched Keccak in a one-rank
    NCCL group, each against its one-device or host reference computed
    outside the counted window."""
    import numpy as np
    import torch.distributed as dist

    from zkpoa_tpu_torch import _build, host
    from zkpoa_tpu_torch.experiments import msm_stages as H
    from zkpoa_tpu_torch.fields import bn254, secp256k1
    from zkpoa_tpu_torch.models.layers import LayerOneInput, layer_one_circuit
    from zkpoa_tpu_torch.ops import keccak as K
    from zkpoa_tpu_torch.ops import limbs as L
    from zkpoa_tpu_torch.ops import ntt as N
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.parallel import mesh as PM
    from zkpoa_tpu_torch.parallel.batch_prove import prove_batched
    from zkpoa_tpu_torch.parallel.ntt_dist import quotient_dist
    from zkpoa_tpu_torch.pipeline import fixtures
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.pipeline.workflow import load_anon_set
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover.prove import prove
    from zkpoa_tpu_torch.prover.setup import setup_device

    t_phase = time.time()
    out = {"ntt": check_ntt_batched(torch, checks, gen)}
    store = os.path.join(OUT_DIR, "pg_store")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    batch_mesh, data_mesh = PM.make_mesh(1, "batch"), PM.make_mesh(1, "data")
    grid = PM.make_hierarchical_mesh(shape=(1, 1))

    # the references, outside the counted window
    atts = parse_signatures_file(os.path.join(RUN2, "sigs.json"))
    t0 = time.perf_counter()
    builds = []
    for att in atts:
        circuit = layer_one_circuit([LayerOneInput.from_json_entry(layer_one_input([att]), 0)])
        builds.append(circuit.compile() + (circuit.public_values,))
    build_s = time.perf_counter() - t0
    r1cs = builds[0][0]
    wits = [w for _, w, _ in builds]
    t0 = time.perf_counter()
    pk = setup_device(r1cs, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    seed = "chip-smoke-batch"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seq = [prove(pk, r1cs, w, "cuda", seed=f"{seed}-b{i}") for i, w in enumerate(wits)]
    torch.cuda.synchronize()
    seq_s, seq_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    a_ev = rand_field(torch, L.BN254_FR, 1 << LAYER_ONE_LOG_DOMAIN, gen)
    b_ev = rand_field(torch, L.BN254_FR, 1 << LAYER_ONE_LOG_DOMAIN, gen)
    c_ev = L.mont_mul(L.BN254_FR, a_ev, b_ev)  # A*B - C vanishes on the domain
    h_want, quotient_ms = once_ms(torch, lambda: N.quotient(a_ev, b_ev, c_ev))
    gens, scal = H.host_inputs(MSM_STAGES_LOG_N)
    table = H.fixed_base_points(BN254_G1, gens, "cuda")
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to("cuda")
    msm_want = [bn254.g1_mul(bn254.G1_GEN, sum(s * g for s, g in zip(ss, gens)) % bn254.R)
                for ss in (scal, scal[-1:] + scal[:-1])]
    rng = np.random.default_rng(5)
    raw = rng.bytes(64 << 16)
    pubs = [(int.from_bytes(raw[64 * i:64 * i + 32], "big"),
             int.from_bytes(raw[64 * i + 32:64 * i + 64], "big")) for i in range(1 << 16)]
    t0 = time.perf_counter()
    addr_cpu = K.eth_addresses_batch(pubs, device="cpu")
    keccak_cpu_s = time.perf_counter() - t0
    signers = [secp256k1.pubkey_from_private(k) for k in fixtures.deterministic_keys(2)]

    # the path, counted
    _build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    batched_s = []
    for k in range(2):  # the first call's collective sets up the group's communicator
        t0 = time.perf_counter()
        proofs = prove_batched(pk, r1cs, wits, batch_mesh, seed=seed)
        torch.cuda.synchronize()
        batched_s.append(time.perf_counter() - t0)
        if k == 0:
            counts_prove = dict(_build.COUNTS)
    batched_peak = torch.cuda.max_memory_allocated()
    dist_ms = []
    for _ in range(2):  # the first call builds the power tables
        h_dist, ms = once_ms(torch, lambda: quotient_dist(a_ev, b_ev, c_ev, data_mesh))
        dist_ms.append(ms)
    t0 = time.perf_counter()
    msm_got = [PM.msm_sharded(BN254_G1, table, sc, data_mesh)]
    msm_sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    msm_got += PM.msm_batch_sharded(BN254_G1, table, torch.stack([sc, sc.roll(1, 0)]), grid)
    msm_batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    addr_card = K.eth_addresses_batch(pubs)
    keccak_s = time.perf_counter() - t0
    signer_addrs = K.eth_addresses_batch(signers)
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    dist.destroy_process_group()

    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    for i, (p, q, (_, _, publics)) in enumerate(zip(proofs, seq, builds)):
        if json.dumps(p.to_json()) != json.dumps(q.to_json()):
            fail(f"prove_batched's proof {i} differs from the sequential prove's")
        if not groth16.verify(vk, p, publics):
            fail(f"prove_batched's proof {i} does not verify")
    passes = len(N.ntt_passes(LAYER_ONE_LOG_DOMAIN, N.TILE_LOG))
    if counts_prove.get("ntt_pass") != 7 * passes:
        fail(f"prove_batched launched {counts_prove.get('ntt_pass')} NTT passes for two "
             f"witnesses, expected one a pass of its 7 transforms ({7 * passes})")
    if not torch.equal(h_dist, h_want):
        fail("quotient_dist at 2^21 differs from ops.ntt.quotient")
    if msm_got != [msm_want[0], msm_want[0], msm_want[1]]:
        fail("msm_sharded / msm_batch_sharded at 2^20 are not (sum s_i g_i mod r) G")
    if addr_card != addr_cpu:
        fail("eth_addresses_batch on the card differs from its CPU run")
    if addr_card[:1 << 10] != [K.eth_address(p) for p in pubs[:1 << 10]]:
        fail("eth_addresses_batch differs from the host eth_address")
    anon = set(load_anon_set(os.path.join(RUN2, "anon.csv"))[0])
    if not all(a in anon for a in signer_addrs) or sorted(signer_addrs) != [a.address for a in atts]:
        fail("the recorded signers' addresses are not those of the anonymity set and sigs.json")
    msgs = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).reshape(-1, 64).copy()).to("cuda")
    keccak_ms = time_ms(torch, lambda: K.keccak256_fixed_batch(msgs), 5)

    out.update(build_s=build_s, setup_s=setup_s, sequential_s=seq_s, sequential_peak=seq_peak,
               batched_s=batched_s, batched_peak=batched_peak, launches_prove=counts_prove,
               quotient_ms=quotient_ms, quotient_dist_ms=dist_ms, msm_sharded_s=msm_sharded_s,
               msm_batch_sharded_s=msm_batch_s, keccak_card_s=keccak_s,
               keccak_cpu_s=keccak_cpu_s, keccak_device_ms=keccak_ms,
               wall_s=time.time() - t_phase)
    log(f"batch: layer one x 2 ({r1cs.n_constraints} constraints, 2^{LAYER_ONE_LOG_DOMAIN}; "
        f"build {build_s:.2f} s, setup_device {setup_s:.2f} s): sequential prove {seq_s:.3f} s "
        f"(peak device memory {seq_peak / 2**30:.2f} GiB), prove_batched on a one-rank batch "
        f"mesh {batched_s[0]:.3f} s (the group's first collective), then {batched_s[1]:.3f} s "
        f"(peak {batched_peak / 2**30:.2f} GiB); proofs byte-identical, both verified; NTT "
        f"passes {counts_prove.get('ntt_pass')} for both witnesses")
    log(f"batch: quotient_dist at 2^{LAYER_ONE_LOG_DOMAIN} on a one-rank data mesh "
        f"{dist_ms[0]:.3f} ms (its power tables built), then {dist_ms[1]:.3f} ms, vs ops.ntt"
        f".quotient {quotient_ms:.3f} ms: equal limbs")
    log(f"batch: msm_sharded G1 2^{MSM_STAGES_LOG_N} {msm_sharded_s:.3f} s, msm_batch_sharded "
        f"2 x 2^{MSM_STAGES_LOG_N} on a (1, 1) mesh {msm_batch_s:.3f} s (plans included): exact")
    log(f"batch: eth_addresses_batch of 2^16 public keys on the card {keccak_s:.3f} s (the "
        f"batched hash {keccak_ms:.3f} ms of device time), on the CPU {keccak_cpu_s:.3f} s: "
        f"equal; 2^10 equal to the host; the 2 signers found in the anonymity set")
    log(f"launches in the batch phase: {json.dumps(counts, sort_keys=True)}")
    log(f"batch phase: {out['wall_s']:.1f} s")
    return out, counts


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
        log(f"msm_stages 2^{MSM_STAGES_LOG_N} {name} (occupancy {res['occupancy']}, "
            f"{res['pieces']} pieces of at most {res['piece']} entries, at most "
            f"{res['max_pieces']} a bucket, combine {res['combine_levels']} levels of depth "
            f"{res['combine_depth']}), best ms: "
            + ", ".join(f"{k} {t * 1e3:.4f}" for k, t in summary[name].items()) + "; MSM exact")
    log(f"launches in the msm_stages phase: {json.dumps(counts, sort_keys=True)}")
    # the headline G1 MSM at 2^20 (bench.py's metric and exact check) at the main path's window
    best = summary[f"c{M.auto_c(LAYER_ONE_WIRES)}"]["msm"]
    msm = {"g1_msm_2p20_s": best, "g1_msm_2p20_mpoints_s": (1 << MSM_STAGES_LOG_N) / best / 1e6}
    log(f"G1 MSM at 2^{MSM_STAGES_LOG_N} (plan included): exact; {best * 1e3:.2f} ms -> "
        f"{msm['g1_msm_2p20_mpoints_s']:.3f} Mpoints/s")

    # E1-E3 against the plain version (index_select) at the harness's shapes,
    # each with its call time, device time and bound; E3 at the MSM's shape
    # first, the row the kernels line reports
    for stage, row in gather_rows(torch, G, gather_inputs(torch, H)).items():
        name = f"{row['kernel']}[{stage}]"
        log_gather_row(name, row)
        if row["max_abs_err"] != 0:
            fail(f"{name}: the kernel disagrees with index_select")
        checks.rows[name] = row
    return summary, counts, msm


def gather_inputs(torch, H):
    """(stage, wrapper, tab, idx) of the harness H's `gather_cases` on the
    card, from one seed: random x|y rows [2^20, 16] and a random visit
    order; E3 at the MSM's shape first."""
    import numpy as np

    n = 1 << MSM_STAGES_LOG_N
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    xy = torch.randint(-(2**31), 2**31, (n, 16), generator=gen, dtype=torch.int64,
                       device="cuda").to(torch.int32)
    visit = torch.randint(0, n, (n,), generator=gen, device="cuda").to(torch.int32)
    cases = H.gather_cases(xy, visit, np.random.default_rng(1))
    cases.sort(key=lambda case: case[0] != "g_dma_msm")
    return cases


def profiler_ms(torch, fn, per_call: int, reps: int = GATHER_REPS):
    """(device ms a call, share of the expected kernel records kept, kernel
    names) by torch.profiler over `reps` back-to-back calls of `per_call`
    kernels each, after a warm-up call: the mean recorded kernel times
    per_call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in device_events(json.load(f)) if e["cat"] == "kernel"]
    if not kernels:
        return None, 0.0, []
    names = sorted({e["name"].split("(")[0].replace("void ", "")[:100] for e in kernels})
    return (sum(e["dur"] for e in kernels) / len(kernels) * per_call / 1e3,
            len(kernels) / (reps * per_call), names)


def graph_ms(torch, fn, reps: int = GATHER_REPS) -> float:
    """Device ms a call by CUDA events around one replay of a CUDA graph of
    `reps` calls (captured after a warm-up call on the capture's side
    stream): the kernels back to back with no launch path between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int = GATHER_REPS) -> float:
    """Host clock of one call's enqueue: `reps` calls without a synchronize
    (after one warm-up call and a synchronize), the launch path alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def gather_calls(G, fn, tab, idx, per_call: int) -> dict:
    """key prefix -> (call, kernels a call): the kernel, and index_select
    (its plain version and the library call), each bound to this case."""
    return {"": (lambda: fn(tab, idx), per_call),
            "library_": (lambda: G.gather_rows_plain(tab, idx), 1)}


def gather_rows(torch, G, cases) -> dict:
    """Each gather kernel against index_select (its plain version and the
    library call, key prefix `library_`) on the same inputs: exactness, call
    ms (CUDA events around GATHER_REPS back-to-back calls: the larger of the
    host's launch path and the card's time), host ms (the enqueue alone),
    device ms and the bytes bound (M W 4 written, 4 M of indices and D W 4
    read for the D distinct rows indexed). Kernels a call come from
    `_build.COUNTS` (index_select is one kernel). Device ms is
    torch.profiler's (`device_method` "profiler") where it kept at least
    GATHER_KEPT of the kernel records, else graph ms ("graph"), the time of a
    CUDA graph replay of the same calls, which every row also reports as a
    cross-check. Call and host times are all taken before the first profiler
    session, which may leave later launches slower."""
    from zkpoa_tpu_torch import _build

    rows, timed = {}, []
    for stage, fn, tab, idx in cases:
        launched = sum(_build.COUNTS.values())
        got = fn(tab, idx)
        per_call = sum(_build.COUNTS.values()) - launched
        m, w = idx.shape[0], tab.shape[1]
        want = G.gather_rows_plain(tab, idx)
        n_bytes = m * w * 4 + 4 * m + torch.unique(idx).numel() * w * 4
        bound_ms, bound_by = bound(n_bytes, 0)
        calls = gather_calls(G, fn, tab, idx, per_call)
        row = {"kernel": fn.__name__, "max_abs_err": max_abs_err(torch, got, want),
               "table": list(tab.shape), "rows": m, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": n_bytes}
        for key, (f, _) in calls.items():
            row[f"{key}ms"] = time_ms(torch, f, GATHER_REPS)
            row[f"{key}host_ms"] = host_ms(torch, f)
        rows[stage] = row
        timed.append((row, calls))
    for row, calls in timed:
        for key, (f, per_call) in calls.items():
            prof, kept, names = profiler_ms(torch, f, per_call)
            graph = graph_ms(torch, f)
            by_profiler = prof is not None and kept >= GATHER_KEPT
            row.update({f"{key}device_ms": prof if by_profiler else graph,
                        f"{key}device_method": "profiler" if by_profiler else "graph",
                        f"{key}profiler_ms": prof, f"{key}graph_ms": graph,
                        f"{key}kernels_per_call": per_call, f"{key}records_kept": kept,
                        f"{key}kernel_names": names})
        row["plain_ms"], row["plain_device_ms"] = row["library_ms"], row["library_device_ms"]
    return rows


def log_gather_row(name: str, row: dict) -> None:
    log(f"{name}: max_abs_err={row['max_abs_err']}; " + "; ".join(
        f"{label} call {row[k + 'ms']:.4f} ms, host {row[k + 'host_ms']:.4f} ms, device "
        f"{row[k + 'device_ms']:.4f} ms by {row[k + 'device_method']} (graph "
        f"{row[k + 'graph_ms']:.4f} ms; {row[k + 'kernels_per_call']} kernels a call, "
        f"{row[k + 'records_kept']:.0%} of the profiler's records kept)"
        for label, k in (("kernel", ""), ("index_select", "library_")))
        + f"; bound {row['bound_ms']:.4f} ms ({row['bytes']:.4g} B)")


def gather_profile_main(root: str) -> int:
    """`--gather-profile ROOT`: phase 7's gather rows alone, on the
    zkpoa_tpu_torch package under ROOT and its harness's shapes; one JSON
    line."""
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "zkpoa_tpu_torch", "csrc")):
        fail(f"no zkpoa_tpu_torch package under {root}")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.experiments import msm_stages as H
    from zkpoa_tpu_torch.ops import gather as G

    if not _build.__file__.startswith(root + os.sep):
        fail(f"zkpoa_tpu_torch came from {_build.__file__}, not from {root}")
    _build.lib()
    rows = gather_rows(torch, G, gather_inputs(torch, H))
    for stage, row in rows.items():
        log_gather_row(f"gather profile {row['kernel']}[{stage}]", row)
        if row["max_abs_err"] != 0:
            fail(f"{stage}: {row['kernel']} disagrees with index_select")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": root, "smi": smi, "gathers": rows}), flush=True)
    return 0


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


def device_events(trace) -> list:
    """Kernel, memcpy and memset events of a torch.profiler chrome trace."""
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def kernel_times(dev) -> dict:
    """name -> (device ms, launches) of device events."""
    by_name = {}
    for e in dev:
        name = e["name"].split("(")[0].replace("void ", "")
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    return by_name


def point_kernel_times(by_name) -> dict:
    """(device ms, launches) of every point and chain kernel: B2-B4
    elementwise, the rounds, Horner, the fold, B5-B7, B8, by group."""
    import re

    out = {}
    for name, (ms, n) in by_name.items():
        k = re.search(r"(add_affine_kernel|add_kernel|double_kernel|msm_horner_kernel|"
                      r"point_fold_kernel|msm_piece_kernel|msm_combine_kernel|"
                      r"msm_reduce_kernel|heavy_rounds_kernel|fixed_base_kernel)"
                      r"<zk::(G1|G2)(Field|Tri)>", name)
        if k:  # G2Tri: the G2 formulas on three threads a lane (row_accum.cuh)
            layout = k.group(2) + ("Tri" if k.group(3) == "Tri" else "")
            out[f"{k.group(1)}<{layout}>"] = (ms, n)
    return out


B1_NAMES = ("field_mont_mul", "field_add_mod", "field_sub_mod")


def quotient_split(trace, dev, phases, phase_counts) -> dict:
    """The quotient phase of a profiled prove: its host clock, its device
    time by kind (NTT passes, B1, other kernels, copies, memsets) from the
    device events inside the phase's range, and its launch counts."""
    qi = next(i for i, p in enumerate(phases) if p.startswith("prove: quotient"))
    rng = next(e for e in trace["traceEvents"] if e.get("name") == f"chip_smoke_phase_{qi}"
               and e.get("cat") == "user_annotation")
    lo, hi = rng["ts"], rng["ts"] + rng["dur"]
    split = {}
    for e in dev:
        if not lo <= e["ts"] <= hi:
            continue
        if e["cat"] != "kernel":
            kind = e["cat"].removeprefix("gpu_")
        elif "ntt_pass_kernel" in e["name"]:
            kind = "ntt_pass"
        elif "field_binop_kernel" in e["name"]:
            kind = "B1"
        else:
            kind = "other kernels"
        ms, k = split.get(kind, (0.0, 0))
        split[kind] = (ms + e["dur"] / 1e3, k + 1)
    before = phase_counts[qi - 1] if qi else {}
    launches = {k: v - before.get(k, 0) for k, v in phase_counts[qi].items()
                if v - before.get(k, 0)}
    return {"host_ms": rng["dur"] / 1e3, "device": split, "launches": launches}


def copy_gather_split(dev) -> dict:
    """(device ms, count) of the device events that move data rather than
    compute: index gathers (`t[idx]`, index_select), cat and copy kernels,
    and memcpys by direction; the heavy-value sums' rounds added a gather
    and a concatenation per round before the rounds kernel."""
    split = {}
    for e in dev:
        name = e["name"]
        if e["cat"] == "gpu_memcpy":
            kind = name.split("(")[0].strip()  # Memcpy HtoD / DtoH / DtoD
        elif "gather_kernel" in name or "indexSelect" in name or "index_elementwise" in name:
            kind = "index gathers"
        elif "CatArrayBatchedCopy" in name or "direct_copy_kernel" in name:
            kind = "cat and copy kernels"
        else:
            continue
        ms, k = split.get(kind, (0.0, 0))
        split[kind] = (ms + e["dur"] / 1e3, k + 1)
    return split


def profile_setup(torch, r1cs) -> dict:
    """One setup_device of the circuit under torch.profiler: wall, device
    busy, B8's device ms and launches by group with its bound (the chunks'
    non-zero 8-bit digits, each a mixed add, the table read once and each
    scalar and point once), and the Jacobian-to-affine conversion of every
    chunk (a Fermat inversion on B1 launches): its B1 launches and device
    ms, its other kernels and copies. Each B8 call and each conversion runs
    in a range of its own, entered and left after a synchronize, so that
    its device events lie inside it (the syncs add a few ms to the wall)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.ops.curve import BN254_G1
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2
    from zkpoa_tpu_torch.prover import setup as S

    curves = (BN254_G1, BN254_G2)
    saved_b8 = S.fixed_base_mul_batch
    saved_affine = [type(c).__dict__["to_affine"] for c in curves]
    calls, digits = [], []

    def wrap(kind, fn):
        def inner(*args):
            torch.cuda.synchronize()
            before = dict(_build.COUNTS)
            with record_function(f"chip_smoke_setup_{kind}_{len(calls)}"):
                out = fn(*args)
                torch.cuda.synchronize()
            after = dict(_build.COUNTS)
            calls.append((kind, {k: v - before.get(k, 0) for k, v in after.items()
                                 if v != before.get(k, 0)}))
            return out
        return inner

    def b8(ops, base, scalars, n_bits):
        digits.append((ops.group, scalars.shape[0],
                       (scalars.contiguous().view(torch.uint8) != 0).sum()))
        return wrap("b8", saved_b8)(ops, base, scalars, n_bits)

    S.fixed_base_mul_batch = b8
    for c in curves:  # each curve's own conversion, wrapped on its class
        type(c).to_affine = staticmethod(wrap(f"affine_g{c.group}", c.to_affine))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pk = S.setup_device(r1cs, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        S.fixed_base_mul_batch = saved_b8
        for c, fn in zip(curves, saved_affine):
            setattr(type(c), "to_affine", fn)
    path = os.path.join(OUT_DIR, "setup_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    del pk
    return {"wall_s": wall, **setup_split(trace, calls, [(g, n, int(d)) for g, n, d in digits])}


def setup_split(trace, calls, digits) -> dict:
    """The setup profile's numbers from its chrome trace, the launch-count
    differences of its B8 and conversion calls, and (group, scalars,
    non-zero digits) of each B8 call."""
    dev = device_events(trace)
    if not dev:
        fail("the profiled setup shows no device work")
    busy = busy_us(dev) / 1e6
    ranges = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("chip_smoke_setup_")]
    b8_ms = {}
    for e in dev:
        if "fixed_base_kernel" in e["name"]:
            g = "g2" if "G2" in e["name"] else "g1"
            ms, k, each = b8_ms.get(g, (0.0, 0, []))
            b8_ms[g] = (ms + e["dur"] / 1e3, k + 1, each + [round(e["dur"] / 1e3, 4)])
    conv = {}  # group -> kind -> (device ms, events)
    for rng in ranges:
        kind = rng["name"].split("_")[3]  # b8 or affine
        if kind != "affine":
            continue
        g = rng["name"].split("_")[4]
        lo, hi = rng["ts"], rng["ts"] + rng["dur"]
        for e in dev:
            if not lo <= e["ts"] <= hi:
                continue
            what = ("B1" if "field_binop_kernel" in e["name"] else
                    "other kernels" if e["cat"] == "kernel" else e["cat"].removeprefix("gpu_"))
            ms, k = conv.setdefault(g, {}).get(what, (0.0, 0))
            conv[g][what] = (ms + e["dur"] / 1e3, k + 1)
    launches = {}
    for kind, diff in calls:
        tot = launches.setdefault(kind, {})
        for k, v in diff.items():
            tot[k] = tot.get(k, 0) + v
    work = {}  # B8's chunks, non-zero digits and bound by group
    for g in (1, 2):
        cb = COORD_BYTES[g]
        runs = [(n, d) for grp, n, d in digits if grp == g]
        if runs:
            n_bytes = sum(32 * 256 * (2 * cb + 1) + n * (32 + 3 * cb) for n, _d in runs)
            n_ops = sum(d for _n, d in runs) * PRODUCTS["add_affine"][g] * MONT_OPS
            work[f"g{g}"] = {"chunks": [n for n, _d in runs], "digits": sum(d for _n, d in runs),
                             "bound": list(bound(n_bytes, n_ops))}
    return {"busy_s": busy,
            "b8": {g: {"ms": ms, "launches": k, "each_ms": each, **work.get(g, {})}
                  for g, (ms, k, each) in b8_ms.items()},
            "affine": {g: {kind: list(v) for kind, v in d.items()} for g, d in conv.items()},
            "launches": launches, "device_events": len(dev)}


def log_setup_profile(prof: dict) -> None:
    log(f"profile setup: wall {prof['wall_s']:.3f} s, device busy {prof['busy_s']:.3f} s "
        f"({prof['device_events']} device events), idle "
        f"{100 * (1 - prof['busy_s'] / prof['wall_s']):.1f} %")
    for g, v in sorted(prof["b8"].items()):
        b = v.get("bound", [float("nan"), "?"])
        log(f"profile setup B8 {g}: {v['ms']:.3f} ms in {v['launches']} launches "
            f"(each {v['each_ms']} ms; chunks {v.get('chunks')}, {v.get('digits')} non-zero "
            f"digits); bound {b[0]:.3f} ms ({b[1]}), share of bound {100 * b[0] / v['ms']:.0f} %")
    for g, d in sorted(prof["affine"].items()):
        log(f"profile setup Jacobian-to-affine {g}: " + ", ".join(
            f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in sorted(d.items()))
            + f"; launches {json.dumps(prof['launches'].get('affine_' + g, {}), sort_keys=True)}")


def profile_prove(torch, checks):
    """A warm layer-one prove under torch.profiler: wall, device busy time
    and idle share, phase ends, kernels by device time, every point and
    chain kernel's device time and launches, the prove's launch counts and
    MSM copies to the host, peak memory; then the rounds kernel at the
    prove's own heavy segments (`check_prove_rounds`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.ops import ntt as N
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import groth16
    from zkpoa_tpu_torch.prover.prove import _sync, prove
    from zkpoa_tpu_torch.prover.setup import setup_device
    from zkpoa_tpu_torch.utils import trace

    circuit, _name = cli._build_circuit("one", layer_one_input(parse_signatures_file(SIGS)), False)
    r1cs, witness = circuit.compile()
    setup_prof = profile_setup(torch, r1cs)
    log_setup_profile(setup_prof)
    pk = setup_device(r1cs, "cuda")
    unprofiled = []
    for _ in range(2):
        t0 = time.perf_counter()
        prove(pk, r1cs, witness, "cuda")
        _sync("cuda")
        unprofiled.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    phases, phase_counts = [], []
    ranges = [record_function("chip_smoke_phase_0")]

    def on_phase(msg):
        # a phase ends after a synchronize: close its range, snapshot the
        # launch counts, open the next phase's range
        ranges[-1].__exit__(None, None, None)
        phases.append(msg)
        phase_counts.append(dict(_build.COUNTS))
        ranges.append(record_function(f"chip_smoke_phase_{len(phases)}"))
        ranges[-1].__enter__()

    _build.reset_counts()
    with trace.collect() as events, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ranges[0].__enter__()
        proof = prove(pk, r1cs, witness, "cuda", log=on_phase)
        _sync("cuda")
        ranges[-1].__exit__(None, None, None)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = dict(_build.COUNTS)
    syncs = {}  # copies of MSM results to the host, by group
    for e in events:
        if e["kind"] == "count" and e["name"] == "host_sync" and \
                e["site"].startswith("msm_decode"):
            syncs[e["site"]] = syncs.get(e["site"], 0) + e["n"]
    if not groth16.verify(groth16.VerifyingKey.from_json(pk.vk_json), proof,
                          circuit.public_values):
        fail("the profiled proof does not verify")
    prove_rounds = check_prove_rounds(torch, checks, pk, witness)
    path = os.path.join(OUT_DIR, "prove_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    dev = device_events(trace)
    busy = busy_us(dev) / 1e6
    by_name = kernel_times(dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    chain_kernels = point_kernel_times(by_name)
    msm_launches = {}  # each launch of the MSM kernels, in order, ms
    for e in sorted(dev, key=lambda e: e["ts"]):
        for k in ("msm_piece_kernel", "msm_combine_kernel", "msm_reduce_kernel"):  # B5/B6, B7
            if k in e["name"]:
                g = "G2" if "G2Field" in e["name"] else "G1"
                msm_launches.setdefault(f"{k}<{g}>", []).append(e["dur"] / 1e3)
    log(f"profile: unprofiled warm proves {[round(t, 3) for t in unprofiled]} s; profiled "
        f"prove wall {wall:.3f} s, device busy {busy:.3f} s ({len(dev)} device events), "
        f"idle {100 * (1 - busy / wall):.1f} %; peak device memory {peak / 2**30:.2f} GiB")
    log("profile phase ends: " + "; ".join(p.removeprefix("prove: ") for p in phases))
    for name, (ms, n) in top:
        log(f"profile kernel {ms:9.3f} ms {n:5d}x {name[:110]}")
    for name, times in msm_launches.items():
        log(f"profile {name} per launch ms: {[round(t, 3) for t in times]}")
    log("profile point and chain kernels, device ms / launches: " + "; ".join(
        f"{k} {ms:.3f} / {n}" for k, (ms, n) in sorted(chain_kernels.items())))
    moves = copy_gather_split(dev)
    log("profile gathers and copies, device ms / count: " + "; ".join(
        f"{k} {ms:.3f} / {n}" for k, (ms, n) in sorted(moves.items())))
    log(f"profile launches: {json.dumps(counts, sort_keys=True)}; MSM copies to the host: "
        f"{json.dumps(syncs, sort_keys=True)}")
    if not dev:
        fail("the profiled prove shows no device work")
    quot = quotient_split(trace, dev, phases, phase_counts)
    log(f"profile quotient phase: host {quot['host_ms']:.2f} ms; device "
        + ", ".join(f"{k} {v[0]:.3f} ms / {v[1]}" for k, v in quot["device"].items())
        + f"; launches {json.dumps(quot['launches'], sort_keys=True)}")
    max_passes = 7 * -(-LAYER_ONE_LOG_DOMAIN // N.TILE_LOG)
    b1_quot = sum(quot["launches"].get(k, 0) for k in B1_NAMES)
    if not 0 < counts.get("ntt_pass", 0) <= max_passes or b1_quot > QUOTIENT_B1_MAX:
        fail(f"a warm prove launched {counts.get('ntt_pass', 0)} NTT passes and its quotient "
             f"phase {b1_quot} B1 launches: expected 1 to {max_passes} (7 transforms of "
             f"ceil({LAYER_ONE_LOG_DOMAIN} / {N.TILE_LOG}) passes) and at most {QUOTIENT_B1_MAX}")
    horner = (counts.get("msm_horner_g1", 0), counts.get("msm_horner_g2", 0))
    rounds = (counts.get("heavy_rounds_g1", 0), counts.get("heavy_rounds_g2", 0))
    b2 = counts.get("point_add_affine_g1", 0) + counts.get("point_add_affine_g2", 0)
    folds = counts.get("point_fold_g1", 0) + counts.get("point_fold_g2", 0)
    one_decode = {"msm_decode_g1": 1, "msm_decode_g2": 1}  # one copy to the host a group
    if horner != (1, 1) or rounds != (1, 1) or b2 or folds > 4 or syncs != one_decode:
        fail(f"a warm prove launched Horner {horner} times (G1, G2), the rounds kernel "
             f"{rounds} times, the elementwise B2 {b2} times, the fold {folds} times and copied "
             f"MSM results to the host {syncs}: expected (1, 1), (1, 1), 0, at most 4 and "
             f"{one_decode}")
    return {"unprofiled_s": unprofiled, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall, "peak_bytes": peak, "phases": phases,
            "top": [[name, ms, n] for name, (ms, n) in top], "msm_launches_ms": msm_launches,
            "chain_kernels": {k: [ms, n] for k, (ms, n) in chain_kernels.items()},
            "gathers_copies": {k: [ms, n] for k, (ms, n) in moves.items()}, "setup": setup_prof,
            "prove_rounds": prove_rounds,
            "launches": counts, "msm_host_syncs": syncs, "quotient": quot,
            "phase_launches": phase_counts}


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


def ptxas_msm_kernels(path: str) -> dict:
    """Registers, stack frame and spill stores/loads (bytes) of each MSM
    kernel entry (msm_piece / msm_combine / msm_reduce / msm_horner and
    point_fold, G1 and G2), of the NTT pass kernel, of the kernels on the
    row-accumulation core (fixed_base, heavy_rounds) and of the ladder
    kernels (scalar_mul, ntt_stage) from the ptxas log."""
    import re

    out, cur, props = {}, None, None
    with open(path) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                name = m.group(1)
                k = re.search(r"(msm_\w+?_kernel|point_fold_kernel|ntt_pass_kernel|"
                              r"fixed_base_kernel|heavy_rounds_kernel|scalar_mul_kernel|"
                              r"ntt_stage_kernel)", name)
                g = ("<G2Tri>" if "G2Tri" in name else "<G2>" if "G2Field" in name
                     else "<G1>" if "G1Field" in name else "")
                props = f"{k.group(1)}{g}" if k else None
                if "Compiling entry" in line:
                    cur = props
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and props:
                out.setdefault(props, {}).update(stack_frame=int(m.group(1)),
                                                 spill_stores=int(m.group(2)),
                                                 spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def setup_profile_main(root: str) -> int:
    """`--setup-profile ROOT`: the setup profile of phase 9 alone, on the
    zkpoa_tpu_torch package under ROOT, after one unprofiled setup of the
    same circuit (tables encoded, kernels loaded); one JSON line."""
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "zkpoa_tpu_torch", "csrc")):
        fail(f"no zkpoa_tpu_torch package under {root}")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    os.makedirs(OUT_DIR, exist_ok=True)
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover.setup import setup_device

    if not _build.__file__.startswith(root + os.sep):
        fail(f"zkpoa_tpu_torch came from {_build.__file__}, not from {root}")
    _build.lib()
    circuit, _name = cli._build_circuit("one", layer_one_input(parse_signatures_file(SIGS)), False)
    r1cs, _witness = circuit.compile()
    setup_device(r1cs, "cuda")
    torch.cuda.synchronize()
    prof = profile_setup(torch, r1cs)
    log_setup_profile(prof)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": root, "smi": smi, "setup": prof}), flush=True)
    return 0


def ceremony_profile_main(root: str) -> int:
    """`--ceremony-profile ROOT`: on the zkpoa_tpu_torch package under ROOT,
    a power-21 dev ceremony, then layer one's phase-1 key from it
    (`setup_from_ptau`, its split), then each stage of the three G1 and the
    G2 transforms once (CUDA events a stage), then K2's top stage over 3 x
    2^21 G1 and 2^21 G2 points and K1's 1/m scales and wire entries, each
    launched as
    that package's path launches it (its twiddle form, its scalar form, its
    entry order), by CUDA events over 2 launches after one; the bounds by
    this script's rule (`ladder_products`). One JSON line: an A/B of the
    ceremony's kernels and setup on one card."""
    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "zkpoa_tpu_torch", "csrc")):
        fail(f"no zkpoa_tpu_torch package under {root}")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    os.makedirs(OUT_DIR, exist_ok=True)
    from zkpoa_tpu_torch import _build
    from zkpoa_tpu_torch.fields.bn254 import R
    from zkpoa_tpu_torch.ops import curve as C
    from zkpoa_tpu_torch.ops import group_ntt as G
    from zkpoa_tpu_torch.ops.fp2 import BN254_G2
    from zkpoa_tpu_torch.ops.limbs import BN254_FR
    from zkpoa_tpu_torch.ops.ntt import _bitrev, _twiddles
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures_file
    from zkpoa_tpu_torch.prover import __main__ as cli
    from zkpoa_tpu_torch.prover import ptau as P

    if not _build.__file__.startswith(root + os.sep):
        fail(f"zkpoa_tpu_torch came from {_build.__file__}, not from {root}")
    windowed = hasattr(C, "booth_digits")  # this PR's K1 / K2, else the binary ladder's
    _build.lib()
    circuit, _name = cli._build_circuit("one", layer_one_input(parse_signatures_file(SIGS)), False)
    r1cs, _witness = circuit.compile()
    log_m = CEREMONY_POWER
    m = 1 << log_m
    path = os.path.join(OUT_DIR, f"profile_{os.getpid()}.ptau")
    out = {"root": root, "windowed": windowed}
    try:
        P.write_dev_ptau(path, log_m, seed=CEREMONY_SEED, device="cuda")
        times = {}
        t0 = time.perf_counter()
        P.setup_from_ptau(r1cs, path, "cuda", times=times)
        torch.cuda.synchronize()
        out["setup_s"], out["split"] = time.perf_counter() - t0, times
        log(f"ceremony profile ({root}): layer one's phase-1 key {out['setup_s']:.2f} s; "
            f"{P.setup_split(times)}")
        pt = P.read_ptau(path, "cuda", m)
    finally:
        if os.path.exists(path):
            os.remove(path)
    packed = r1cs.pack()
    mag, _neg, unit, zero = P._pool_split(packed.pool_limbs)
    rev = _bitrev(log_m, "cuda")
    table = BN254_FR.from_mont(_twiddles(log_m, True, "cuda"))
    top = table[:: m >> log_m]
    minv = torch.from_numpy(BN254_FR.to_limbs([pow(m, -1, R)])).to("cuda")
    groups = ((C.BN254_G1, ("tau_g1", "alpha_tau_g1", "beta_tau_g1"),
               [(0, packed.a), (0, packed.b), (2 * m, packed.a), (m, packed.b), (0, packed.c)]),
              (BN254_G2, ("tau_g2",), [(0, packed.b)]))
    kern, stages = {}, {}
    for curve, names, parts in groups:
        g = curve.group
        srcs = [P._jac(curve, pt[k]) for k in names]
        pts = tuple(torch.cat([src[c][:m][rev] for src in srcs]).contiguous() for c in range(3))
        n = pts[0].shape[0]
        # every stage of the transform once, as lagrange_points runs it
        work = tuple(t.clone() for t in pts)
        dig = C.booth_digits(table) if windowed else table
        stages[f"g{g}"] = [once_ms(torch, lambda: G.stage(
            curve, work, dig[:: m >> (k + 1)] if windowed else dig[:: m >> (k + 1)].contiguous(),
            k))[1] for k in range(log_m)]
        del work, dig
        log(f"ceremony profile ({root}): G{g} stages, half 2^0 .. 2^{log_m - 1}, ms: "
            + ", ".join(f"{v:.1f}" for v in stages[f"g{g}"]))
        tw = C.booth_digits(top) if windowed else top.contiguous()
        work = tuple(t.clone() for t in pts)
        ms = time_ms(torch, lambda: G.stage(curve, work, tw, log_m - 1), 2)
        prods = ladder_products(torch, top, g, np.full(m // 2, n // m, np.int64))
        kern[f"k2_top_g{g}"] = (ms, bound(n * 6 * COORD_BYTES[g],
                                          (prods + n * PRODUCTS["add"][g]) * MONT_OPS)[0])
        del work
        sc = minv if windowed else minv.expand(n, 8).contiguous()
        ms = time_ms(torch, lambda: C.scalar_mul_batch(curve, pts, sc, 254), 2)
        kern[f"k1_minv_g{g}"] = (ms, bound(n * 6 * COORD_BYTES[g],
                                           ladder_products(torch, minv, g, [n]) * MONT_OPS)[0])
        if windowed:  # the path's entry order
            r_idx, cid, _rank = P._scaled_entries([parts], unit, zero)
        else:  # the parent's: R1CS order
            rows, cids = [], []
            for off, mat in parts:
                keep = ~zero[mat.cid] & ~unit[mat.cid]
                rows.append(off + mat.idx[keep].astype(np.int64))
                cids.append(mat.cid[keep])
            r_idx, cid = np.concatenate(rows), np.concatenate(cids)
        flat = tuple(torch.cat([src[c][:m] for src in srcs]) for c in range(3))
        wpts = tuple(t[torch.from_numpy(r_idx).to("cuda")].contiguous() for t in flat)
        wsc = torch.from_numpy(mag[cid]).to("cuda")
        ms = time_ms(torch, lambda: C.scalar_mul_batch(curve, wpts, wsc, 254), 2)
        kern[f"k1_wires_g{g}"] = (ms, bound(len(cid) * (6 * COORD_BYTES[g] + 32),
                                            ladder_products(torch, wsc, g) * MONT_OPS)[0])
        del pts, flat, wpts, srcs
        torch.cuda.empty_cache()
    for k, (ms, b) in kern.items():
        log(f"ceremony profile ({root}): {k} {ms:.3f} ms, bound {b:.3f} ms, share {b / ms:.1%}")
    out["kernels_ms_bound_ms"] = kern
    out["stage_ms"] = stages
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"smi": smi, **out}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--setup-profile":
        return setup_profile_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--gather-profile":
        return gather_profile_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--ceremony-profile":
        return ceremony_profile_main(sys.argv[2])
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
    msm_regs = ptxas_msm_kernels(_build.BUILD_INFO["log"])
    log("ptxas MSM, fold, NTT, row-accumulation and ladder kernels: " + "; ".join(
        f"{k} {v.get('registers')} registers, stack frame {v.get('stack_frame')} B, spill "
        f"stores {v.get('spill_stores')} B, loads {v.get('spill_loads')} B"
        for k, v in sorted(msm_regs.items())))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = Checks(torch)
    check_field(torch, checks, gen)
    check_points(torch, checks, gen)
    fb_stats = check_fixed_base(torch, checks)
    rounds_stats = check_heavy_rounds(torch, checks, gen)
    mont_ms = mont_latency(torch, checks, gen)
    ntt_stats = {f"2^{k}": check_ntt(torch, checks, gen, k)
                 for k in (LAYER_ONE_LOG_DOMAIN, LAYER_TWO_LOG_DOMAIN)}
    check_msm(torch, checks, gen)
    stats, counts_l1 = main_path(torch)
    with tempfile.TemporaryDirectory() as tmp:
        wf, counts_wf, bdir = workflow_path(torch, tmp)
        rec2, counts_rec = recursive_layer_two(torch, checks, gen, bdir)
        ab = setup_ab(torch, bdir)
    stages, counts_ms, msm_stats = msm_stages_path(torch, checks)
    cer, counts_cer = ceremony_path(torch, checks)
    batch, counts_batch = batch_multi_gpu(torch, checks, gen)
    phases = (counts_l1, counts_wf, counts_rec, counts_ms, counts_cer, counts_batch)
    counts = {k: sum(c.get(k, 0) for c in phases) for k in set().union(*phases)}
    missing = [k for k in KERNELS if k not in PHASE3_ONLY and counts.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched by the layer-one, workflow, recursive layer-two, "
             f"msm_stages, ceremony workflow and batch phases: {missing}")
    merkle = merkle_2p20(torch)
    prof = profile_prove(torch, checks)
    with open(os.path.join(OUT_DIR, "stats.json"), "w") as f:
        json.dump({"main_path": stats, "launches": counts, "launches_layer_one": counts_l1,
                   "launches_workflow": counts_wf, "launches_msm_stages": counts_ms,
                   "launches_recursive_layer_two": counts_rec, "recursive_layer_two": rec2,
                   "launches_ceremony_workflow": counts_cer, "ceremony": cer,
                   "launches_batch": counts_batch, "batch": batch,
                   "kernels": checks.rows, "fixed_base": fb_stats, "heavy_rounds": rounds_stats,
                   "msm": msm_stats,
                   "msm_stages": stages, "workflow": wf, "setup_ab": ab, "merkle": merkle,
                   "profile": prof, "ptxas_msm": msm_regs, "mont_latency_ms": mont_ms,
                   "ntt": ntt_stats,
                   "device": name, "smi": smi},
                  f, indent=1)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_rows(checks, counts)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_rows(checks, counts):
    """The kernels line: each kernel's numbers from its first check,
    `checks` listing every check of it, by shape."""
    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        rows = [r for k, r in checks.rows.items() if k.split("[")[0] == kname]
        entry = {
            "name": kname, "route": "cuda", "source": f"zkpoa_tpu_torch/{src}",
            "replaces": replaces, "launches": counts.get(kname, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0]["library_ms"],  # None where no PyTorch call computes it
        }
        for key in ("latency_bound_ms", "device_ms", "library_device_ms"):
            if key in rows[0]:
                entry[key] = rows[0][key]
        entry["checks"] = [
            {"shape": k[len(kname):].strip("[]") or "phase 3",
             **{f: r[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}}
            for k, r in checks.rows.items() if k.split("[")[0] == kname]
        if kname in PHASE3_ONLY:
            entry["checked"] = "phase 3 only"
        kernels.append(entry)
    return kernels


if __name__ == "__main__":
    sys.exit(main())
