"""The variable-base ladder (K1) and the group-NTT butterfly stage (K2) in
their plain versions, their launchers' refusals, and the CLI entry points
of the ceremony / interop slice.

* `ops/curve.py` `scalar_mul_plain` (the signed-window ladder of kernel
  K1) against host `g1_mul` / `g2_mul` for k in {0, 1, 2, r - 1, random},
  points at infinity, several batch sizes; and, on the window's edges (0,
  1, 2, 2^w - 1, 2^w, 2^(w-1), 2^254 - 1, 2^253, r - 1, powers 2^k, and
  scalars whose last window add meets P == Q or P == -Q), against the host
  and the JAX package's `curve_jax.scalar_mul_batch`, a scalar a lane and
  one scalar for every lane; `booth_digits` sums back to the scalar;
* `ops/group_ntt.py` `stage_plain` against host u + [w] v, u - [w] v for
  half = 1 .. 8, stages of 1 to 32 blocks;
* `field_kernels.scalar_mul` / `group_ntt_stage` refuse CPU tensors and
  shapes they cannot take (the kernels themselves: tests/test_torch_cuda.py);
* the prover CLI's `export`, `prove-zkey` and `sanitize` through `main`, and
  the workflow's refusal of --contribute / --beacon without --ptau.

Tolerance: exact (decoded points, files)."""

import json
import random

import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp
from zkpoa_tpu.ops import curve_jax
from zkpoa_tpu.ops import msm as jax_msm
from zkpoa_tpu.ops.fp2_jax import BN254_G2 as JG2
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.fields.bn254 import R
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.ops import curve as C
from zkpoa_tpu_torch.ops import field_kernels as FK
from zkpoa_tpu_torch.ops.curve import BN254_G1, booth_digits, scalar_mul_batch, scalar_mul_plain
from zkpoa_tpu_torch.ops.fp2 import BN254_G2
from zkpoa_tpu_torch.ops.group_ntt import stage_plain
from zkpoa_tpu_torch.ops.limbs import BN254_FR
from zkpoa_tpu_torch.pipeline import workflow
from zkpoa_tpu_torch.prover import __main__ as cli
from zkpoa_tpu_torch.prover import groth16
from zkpoa_tpu_torch.prover.setup import setup_device
from zkpoa_tpu_torch.utils import binfmt
from zkpoa_tpu_torch.utils.binfmt_torch import write_zkey_device

torch.set_num_threads(1)

GROUPS = {"g1": (BN254_G1, bn254.G1_GEN, bn254.g1_mul, bn254.g1_add, bn254.g1_neg),
          "g2": (BN254_G2, bn254.G2_GEN, bn254.g2_mul, bn254.g2_add, bn254.g2_neg)}
JAX_GROUPS = {"g1": curve_jax.BN254_G1, "g2": JG2}
W = FK.LADDER_W


def _points(group, n, seed):
    ops, gen, mul, _add, _neg = GROUPS[group]
    rng = random.Random(seed)
    return [mul(gen, rng.randrange(1, R)) for _ in range(n)]


def _jac(ops, pts):
    return ops.from_affine(*ops.encode_affine(pts, "cpu"))


def _scalars(ks):
    return torch.from_numpy(BN254_FR.to_limbs(ks))


def _lim(ks):
    """Plain limbs of ks as they are (not reduced mod r)."""
    return torch.from_numpy(host.scalars_to_limbs_fast(ks))


@pytest.mark.parametrize("group,n", [("g1", 1), ("g1", 7), ("g2", 7)])
def test_plain_ladder_equals_host_scalar_mul(group, n, monkeypatch):
    ops, _gen, mul, _add, _neg = GROUPS[group]
    rng = random.Random(n)
    pts = _points(group, n, seed=n)
    ks = ([0, 1, 2, R - 1, rng.randrange(R), rng.randrange(1 << 64)] * 2)[:n]
    if n > 1:
        pts[-1] = None  # a point at infinity
    # the routed entry point takes the plain version for CPU tensors
    ran = []
    monkeypatch.setattr(C, "scalar_mul_plain",
                        lambda *a: ran.append(1) or scalar_mul_plain(*a))
    got = ops.decode_jac(scalar_mul_batch(ops, _jac(ops, pts), _scalars(ks), 254))
    assert ran == [1]
    want = [None if p is None else mul(p, k) for p, k in zip(pts, ks)]
    assert got == want


def _wrapping_scalar(sign):
    """k = a 2^w + d with 0 < |d| <= 2^(w-1) (digit 0 is d, the digits above
    are a's) and a 2^w = sign d mod r: the ladder's accumulator before the
    last add is [sign d] P, so that add meets P == Q (sign 1: k = 2d mod r)
    or P == -Q (sign -1: k = 0 mod r). k stays below 2^254."""
    inv, h = pow(1 << W, -1, R), 1 << (W - 1)
    for d in [*range(1, h + 1), *range(-h, 0)]:
        a = sign * d * inv % R
        if a < (1 << (254 - W)) - 1:
            return (a << W) + d
    raise AssertionError("no wrapping scalar below 2^254")


def _edge_scalars(n, seed):
    rng = random.Random(seed)
    ks = [0, 1, 2, (1 << W) - 1, 1 << W, 1 << (W - 1), (1 << 254) - 1, 1 << 253, R - 1,
          1 << 3, 1 << 31, 1 << 32, 1 << 64, 1 << 200, _wrapping_scalar(1), _wrapping_scalar(-1)]
    return ks + [rng.randrange(R) for _ in range(n - len(ks))]


def test_booth_digits_sum_back_to_the_scalar():
    ks = _edge_scalars(24, seed=5)
    for w in (4, 5):
        for n_bits in (254, 256, 64, 3):
            vals = [k % (1 << n_bits) for k in ks]
            got = booth_digits(torch.from_numpy(host.scalars_to_limbs_fast(ks)), n_bits, w)
            assert got.shape == (len(ks), n_bits // w + 1)
            assert int(got.abs().max()) <= 1 << (w - 1)
            assert [sum(d << (w * i) for i, d in enumerate(row)) for row in got.tolist()] == vals


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_window_ladder_matches_jax_and_host_on_edges(group):
    """A scalar a lane: the window's edge scalars and two that wrap mod r
    (the last add doubles, or gives infinity), a point at infinity, then
    one scalar for every lane, as [8] and [1, 8]: decoded points equal the
    host multiples and the JAX package's binary ladder."""
    ops, _gen, mul, _add, _neg = GROUPS[group]
    ks = _edge_scalars(18, seed=7)
    pts = _points(group, len(ks), seed=17)
    pts[5] = None
    got = ops.decode_jac(scalar_mul_plain(ops, _jac(ops, pts), _lim(ks), 254))
    want = [None if p is None else mul(p, k % R) for p, k in zip(pts, ks)]
    assert got == want
    assert ks[14] % R in (2, R - 2) and want[15] is None  # the P == Q and P == -Q lanes
    jops = JAX_GROUPS[group]
    jsc = jnp.asarray(jax_msm.scalars_to_limbs(ks))
    assert jops.decode_jac(curve_jax.scalar_mul_batch(jops, jops.encode_jac(pts), jsc, 254)) == got
    k = ks[-1]
    for one in (_lim([k])[0], _lim([k])):
        got1 = ops.decode_jac(scalar_mul_batch(ops, _jac(ops, pts), one, 254))
        assert got1 == [None if p is None else mul(p, k) for p in pts]


@pytest.mark.parametrize("group,log_half,m", [("g1", 0, 64), ("g1", 1, 4), ("g1", 2, 8),
                                              ("g1", 3, 16), ("g2", 1, 4), ("g2", 0, 8)])
def test_plain_butterfly_stage_equals_host(group, log_half, m):
    """m / (2 half) blocks: 32 at half = 1 over 64 points, one at the top
    stage of 16."""
    ops, _gen, mul, add, neg = GROUPS[group]
    half = 1 << log_half
    pts = _points(group, m, seed=10 + log_half)
    rng = random.Random(log_half)
    tws = [1] + [rng.randrange(R) for _ in range(half - 1)]
    got = ops.decode_jac(stage_plain(ops, _jac(ops, pts), booth_digits(_scalars(tws)), log_half))
    want = [None] * m
    for blk in range(m // (2 * half)):
        for j in range(half):
            iu, iv = blk * 2 * half + j, blk * 2 * half + half + j
            vt = mul(pts[iv], tws[j])
            want[iu], want[iv] = add(pts[iu], vt), add(pts[iu], neg(vt))
    assert got == want


def test_launchers_refuse_what_the_kernels_cannot_take():
    p = _jac(BN254_G1, _points("g1", 4, seed=3))
    k = _scalars([1, 2, 3, 4])
    with pytest.raises(ValueError, match="CUDA"):
        FK.scalar_mul(FK.G1, p, k, 254)
    with pytest.raises(ValueError, match="CUDA"):
        FK.scalar_mul(FK.G1, p, k[:1], 254)  # the broadcast form too
    with pytest.raises(ValueError, match="CUDA"):
        FK.group_ntt_stage(FK.G1, p, booth_digits(k[:1]), 0)
    with pytest.raises(ValueError, match="CUDA"):
        FK.group_ntt_stage(FK.G1, p, booth_digits(k[:2]), 1)


def _toy():
    c = Circuit()
    out = c.public_output()
    x, y = c.var(5), c.var(9)
    c.bind_output(out, c.mul(x, y) * 3 + x - 7)
    return c


@pytest.fixture(scope="module")
def toy_artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    r1cs, wit = _toy().compile()
    pk = setup_device(r1cs, "cpu", seed="cli")
    write_zkey_device(str(d / "toy.zkey"), pk, r1cs)
    binfmt.write_wtns(str(d / "toy.wtns"), wit)
    with open(d / "toy_vkey.json", "w") as f:
        json.dump(pk.vk_json, f)
    return d, r1cs, wit, pk


def test_cli_prove_zkey_and_sanitize(toy_artifacts):
    d, r1cs, wit, pk = toy_artifacts
    out = d / "out"
    assert cli.main(["prove-zkey", "--zkey", str(d / "toy.zkey"), "--wtns", str(d / "toy.wtns"),
                     "-o", str(out), "--device", "cpu"]) == 0
    publics = [str(w) for w in wit[1 : r1cs.n_public + 1]]
    with open(out / "public.json") as f:
        assert json.load(f) == publics
    vkey = str(d / "toy_vkey.json")
    assert groth16.verify_files(vkey, str(out / "proof.json"), str(out / "public.json"))
    san = str(d / "sanitized.json")
    assert cli.main(["sanitize", vkey, str(out / "proof.json"), str(out / "public.json"),
                     "-o", san]) == 0
    from zkpoa_tpu.pipeline.sanitize import sanitize_files as jax_sanitize_files

    want = jax_sanitize_files(vkey, str(out / "proof.json"), str(out / "public.json"),
                              str(d / "sanitized_jax.json"))
    with open(san) as f:
        assert json.load(f) == json.loads(json.dumps(want))


def test_cli_export_writes_the_artifacts(toy_artifacts, monkeypatch, tmp_path):
    d, r1cs, wit, pk = toy_artifacts
    monkeypatch.setattr(cli, "_build_circuit", lambda layer, dd, rec: (_toy(), "toy"))
    inp = tmp_path / "in.json"
    inp.write_text("{}")
    assert cli.main(["export", "--layer", "one", "--input", str(inp), "-o", str(tmp_path),
                     "--zkey", "--device", "cpu", "--seed", "cli"]) == 0
    assert binfmt.read_wtns(str(tmp_path / "toy.wtns")) == wit
    back = binfmt.read_r1cs(str(tmp_path / "toy.r1cs"))
    assert (back.a_rows, back.b_rows, back.c_rows) == (list(r1cs.a_rows), list(r1cs.b_rows),
                                                       list(r1cs.c_rows))
    with open(tmp_path / "toy.zkey", "rb") as f, open(d / "toy.zkey", "rb") as g:
        assert f.read() == g.read()


def test_workflow_refuses_phase_two_without_ptau(tmp_path):
    with pytest.raises(SystemExit) as e:
        workflow.main(["s.json", "a.csv", "0x1", "--contribute", "E", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        workflow.main(["s.json", "a.csv", "0x1", "--beacon", "H", "--device", "cpu"])
    with pytest.raises(ValueError, match="require ptau_path"):
        workflow.run_workflow("s.json", "a.csv", 1, build_root=str(tmp_path), device="cpu",
                              contribute_entropy="E")

