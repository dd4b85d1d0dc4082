"""The variable-base ladder (K1) and the group-NTT butterfly stage (K2) in
their plain versions, their launchers' refusals, and the CLI entry points
of the ceremony / interop slice.

* `ops/curve.py` `scalar_mul_plain` against host `g1_mul` / `g2_mul` for
  k in {0, 1, 2, r - 1, random}, points at infinity, several batch sizes;
* `ops/group_ntt.py` `stage_plain` against host u + [w] v, u - [w] v;
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
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.fields.bn254 import R
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.ops import curve as C
from zkpoa_tpu_torch.ops import field_kernels as FK
from zkpoa_tpu_torch.ops.curve import BN254_G1, scalar_mul_batch, scalar_mul_plain
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


def _points(group, n, seed):
    ops, gen, mul, _add, _neg = GROUPS[group]
    rng = random.Random(seed)
    return [mul(gen, rng.randrange(1, R)) for _ in range(n)]


def _jac(ops, pts):
    return ops.from_affine(*ops.encode_affine(pts, "cpu"))


def _scalars(ks):
    return torch.from_numpy(BN254_FR.to_limbs(ks))


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


@pytest.mark.parametrize("group,log_half", [("g1", 0), ("g1", 1), ("g2", 1)])
def test_plain_butterfly_stage_equals_host(group, log_half):
    ops, _gen, mul, add, neg = GROUPS[group]
    half = 1 << log_half
    m = 4
    pts = _points(group, m, seed=10 + log_half)
    rng = random.Random(log_half)
    tws = [1] + [rng.randrange(R) for _ in range(half - 1)]
    got = ops.decode_jac(stage_plain(ops, _jac(ops, pts), _scalars(tws), log_half))
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
        FK.group_ntt_stage(FK.G1, p, k[:1], 0)
    with pytest.raises(ValueError, match="CUDA"):
        FK.group_ntt_stage(FK.G1, p, k[:2], 1)


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

