"""zkpoa_tpu_torch CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The port does
not need JAX, so this file imports none, and on a machine without JAX it
runs without the test directory's conftest (which sets JAX up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are made with numpy / torch from fixed seeds. Tolerance: exact
equality of limbs (kernel vs plain) and of decoded points (all of it is
integer arithmetic)."""

import numpy as np
import pytest
import torch

from zkpoa_tpu.fields import bn254
from zkpoa_tpu.models.gadgets.poseidon_gadget import poseidon
from zkpoa_tpu.models.r1cs import Circuit
from zkpoa_tpu.prover import groth16
from zkpoa_tpu_torch import _build, host
from zkpoa_tpu_torch.ops import field_kernels as FK
from zkpoa_tpu_torch.ops import limbs as L
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops.curve import BN254_G1, jac_add, jac_add_affine, jac_double, run_plain
from zkpoa_tpu_torch.ops.fp2 import BN254_G2
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import DeviceG1Points, DeviceG2Points, setup_device

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on it with "
                    "`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`")
    _build.lib()
    return torch.device("cuda")


def _rand(spec, shape, seed):
    """Canonical random field elements [*shape, 8] (plain limbs < p)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "big") % spec.modulus for _ in range(n)]
    vals[:3] = [0, 1, spec.modulus - 1][: len(vals[:3])]
    return torch.from_numpy(host.scalars_to_limbs_fast(vals)).reshape(tuple(shape) + (8,))


@pytest.mark.parametrize("which", ["fq", "fr"])
def test_field_kernels_match_plain(card, which):
    spec = L.BN254_FQ if which == "fq" else L.BN254_FR
    a = _rand(spec, (4099,), 1).to(card)
    b = _rand(spec, (4099,), 2).to(card)
    for op, plain in ((FK.OP_MUL, L.mont_mul_plain), (FK.OP_ADD, L.add_mod_plain),
                      (FK.OP_SUB, L.sub_mod_plain)):
        assert torch.equal(FK.field_binop(spec, op, a, b), plain(spec, a, b))
    # broadcast: one scalar, and an NTT stage's cyclic twiddles
    assert torch.equal(L.mont_mul(spec, a, b[:1]), L.mont_mul_plain(spec, a, b[:1]))
    tw = b[:7]
    x = a[: 7 * 5].reshape(5, 7, 8)
    assert torch.equal(L.mont_mul(spec, x, tw), L.mont_mul_plain(spec, x, tw))


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_point_kernels_match_plain_on_exceptional_cases(card, curve):
    n = 1000
    shape = (n,) + curve.coord_shape[:-1]
    p = tuple(_rand(curve.field, shape, 10 + i).to(card) for i in range(3))
    q = tuple(_rand(curve.field, shape, 20 + i).to(card) for i in range(3))
    xq, yq = (_rand(curve.field, shape, 30 + i).to(card) for i in range(2))
    valid = torch.ones(n, dtype=torch.bool, device=card)
    ar = curve.arith(card)
    one = L.to_i32(ar.one_like(L.u32(p[0][:1]))[0])
    neg = lambda t: L.sub_mod_plain(curve.field, torch.zeros_like(t), t)  # noqa: E731
    p[2][0] = 0  # P = inf
    q[2][1] = 0  # Q = inf
    for i in range(3):  # Q == P
        q[i][2] = p[i][2]
    q[0][3], q[1][3], q[2][3] = p[0][3], neg(p[1][3]), p[2][3]  # Q == -P
    p[0][4], p[1][4], p[2][4] = xq[4], yq[4], one  # affine Q == P
    p[0][5], p[1][5], p[2][5] = xq[5], neg(yq[5]), one  # affine Q == -P
    valid[6] = False  # absent Q
    g = curve.group
    for got, want in (
        (FK.point_add(g, p, q), run_plain(ar, jac_add, p, q)),
        (FK.point_add_affine(g, p, xq, yq, valid), run_plain(ar, jac_add_affine, p, xq, yq, valid)),
        (FK.point_double(g, p), run_plain(ar, jac_double, p)),
    ):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _table(curve, base, add, mul, n, seed, repeat_first=0):
    rng = np.random.default_rng(seed)
    ks = [int(x) for x in rng.integers(1, 2**62, size=n)]
    ks[1 : 1 + repeat_first] = [ks[0]] * repeat_first
    pts = [mul(base, k) for k in ks]
    pts[n // 2] = None  # an absent row
    cls = DeviceG1Points if curve.group == 1 else DeviceG2Points
    return cls(*curve.encode_affine(pts, "cuda")), pts


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_msm_kernels_match_plain_and_host(card, curve):
    if curve.group == 1:
        base, add, mul = bn254.G1_GEN, bn254.g1_add, bn254.g1_mul
    else:
        base, add, mul = bn254.G2_GEN, bn254.g2_add, bn254.g2_mul
    n = 300
    table, pts = _table(curve, base, add, mul, n, 5, repeat_first=20)
    rng = np.random.default_rng(6)
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    scal[1:21] = [scal[0]] * 20  # the same (point, scalar) 21 times: P == Q in a bucket
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card)
    plan = M.plan_msm(sc, 6, split_heavy=False)
    buckets = M.accumulate(curve, table.xs, table.ys, table.valid, 0, plan)
    plain = M.accumulate_plain(curve, table.xs, table.ys, table.valid, 0, plan)
    for a, b in zip(buckets, plain):
        assert torch.equal(a, b)
    for a, b in zip(M.reduce(curve, buckets, plan.nw, plan.nb),
                    M.reduce_plain(curve, buckets, plan.nw, plan.nb)):
        assert torch.equal(a, b)
    want = None
    for p, s in zip(pts, scal):
        if p is not None:
            want = add(want, mul(p, s))
    assert M.msm_shared(curve, table, plan, add, mul) == want


def test_toy_proof_on_card_equals_cpu_proof(card):
    """Setup and prove of a small circuit through the kernels give the same
    key tables and the same proof as the plain versions on the CPU."""
    c = Circuit()
    out = c.public_output()
    c.bind_output(out, poseidon(c, [c.var(7), c.var(11)]))
    r1cs, wit = c.compile()
    pk_gpu = setup_device(r1cs, "cuda", seed="devtest")
    pk_cpu = setup_device(r1cs, "cpu", seed="devtest")
    for name in ("a_query", "b1_query", "c_query", "h_query", "b2_query"):
        tg, tc = getattr(pk_gpu, name), getattr(pk_cpu, name)
        assert torch.equal(tg.xs.cpu(), tc.xs) and torch.equal(tg.ys.cpu(), tc.ys)
        assert torch.equal(tg.valid.cpu(), tc.valid)
    proof = prove(pk_gpu, r1cs, wit, "cuda", seed="p1")
    want = prove(pk_cpu, r1cs, wit, "cpu", seed="p1")
    assert (proof.pi_a, proof.pi_b, proof.pi_c) == (want.pi_a, want.pi_b, want.pi_c)
    vk = groth16.VerifyingKey.from_json(pk_gpu.vk_json)
    assert groth16.verify(vk, proof, [wit[w] for w in range(1, r1cs.n_public + 1)])
