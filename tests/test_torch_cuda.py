"""zkpoa_tpu_torch CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The port does
not need JAX, so this file imports neither JAX nor the JAX package, and on
a machine without JAX it runs without the test directory's conftest (which
sets JAX up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are made with numpy / torch from fixed seeds. Tolerance: exact
equality of limbs (kernel vs plain) and of decoded points (all of it is
integer arithmetic)."""

import json
import warnings

import numpy as np
import pytest
import torch

from zkpoa_tpu_torch import _build, host
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.merkle.tree import MerkleTree
from zkpoa_tpu_torch.models.gadgets.poseidon_gadget import poseidon
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.ops import field_kernels as FK
from zkpoa_tpu_torch.ops import gather as G
from zkpoa_tpu_torch.ops import limbs as L
from zkpoa_tpu_torch.ops import msm as M
from zkpoa_tpu_torch.ops.curve import (BN254_G1, fixed_base_device_table, fixed_base_mul_batch,
                                       fixed_base_plain, jac_add, jac_add_affine, jac_double,
                                       run_plain)
from zkpoa_tpu_torch.ops.fp2 import BN254_G2
from zkpoa_tpu_torch.prover import groth16
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import setup_device
from zkpoa_tpu_torch.utils import trace

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
    return curve.table(*curve.encode_affine(pts, "cuda")), pts


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
    assert M.msm_many(curve, [(table, plan, 0)])[0] == want


def _group(curve):
    if curve.group == 1:
        return bn254.G1_GEN, bn254.g1_add, bn254.g1_mul
    return bn254.G2_GEN, bn254.g2_add, bn254.g2_mul


@pytest.mark.parametrize("piece", [2, 5, M.PIECE])
@pytest.mark.parametrize("c", [6, 11])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_msm_piece_kernels_match_plain(card, curve, c, piece):
    """B5/B6 (pieces, then the combine) equal their plain version limb for
    limb, with P == Q inside and across pieces, absent rows and a
    prefix_pad offset; at c = 11 most buckets are empty."""
    base, add, mul = _group(curve)
    n, pad = 400, 7
    table, _pts = _table(curve, base, add, mul, n - pad, 15, repeat_first=30)
    rng = np.random.default_rng(16)
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    scal[pad + 1 : pad + 31] = [scal[pad]] * 30  # 31 copies of one (point, scalar) pair
    plan = M.plan_msm(torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card), c,
                      split_heavy=False, piece=piece)
    got = M.accumulate(curve, table.xs, table.ys, table.valid, pad, plan)
    torch.cuda.synchronize()
    want = M.accumulate_plain(curve, table.xs, table.ys, table.valid, pad, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threads", [None, 1, 8])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_batched_reduce_matches_plain_and_msm_totals_are_exact(card, curve, threads):
    """B7 over the windows of three MSMs in one launch equals its plain
    version limb for limb; msm_many's totals (one reduction launch for all
    three) equal the host MSMs."""
    base, add, mul = _group(curve)
    n = 200
    table, pts = _table(curve, base, add, mul, n, 17)
    rng = np.random.default_rng(18)
    scals = [[int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)] for _ in range(3)]
    plans = [M.plan_msm(torch.from_numpy(host.scalars_to_limbs_fast(s)).to(card), 6, piece=3)
             for s in scals]
    nw, nb = plans[0].nw, plans[0].nb
    parts = [M.accumulate(curve, table.xs, table.ys, table.valid, 0, p) for p in plans]
    buckets = tuple(torch.cat([b[k] for b in parts]) for k in range(3))
    got = M.reduce(curve, buckets, 3 * nw, nb, threads)
    torch.cuda.synchronize()
    for a, b in zip(got, M.reduce_plain(curve, buckets, 3 * nw, nb, threads)):
        assert torch.equal(a, b)
    _build.reset_counts()
    totals = M.msm_many(curve, [(table, p, 0) for p in plans])
    assert _build.COUNTS.get(f"msm_reduce_g{curve.group}") == 1
    for s, total in zip(scals, totals):
        want = None
        for p, k in zip(pts, s):
            if p is not None:
                want = add(want, mul(p, k))
        assert total == want


def test_msm_kernels_refuse_what_they_cannot_take(card):
    base, add, mul = _group(BN254_G1)
    table, _pts = _table(BN254_G1, base, add, mul, 64, 19)
    sc = torch.from_numpy(host.scalars_to_limbs_fast(list(range(1, 65)))).to(card)
    with pytest.raises(ValueError):
        M.plan_msm(sc, 6, piece=0)
    plan, other = M.plan_msm(sc, 6, piece=2), M.plan_msm(sc, 6, piece=4)
    plan.piece_start, plan.piece_end, plan.piece_ptr = (
        other.piece_start, other.piece_end, other.piece_ptr)
    with pytest.raises(ValueError):
        M.accumulate(BN254_G1, table.xs, table.ys, table.valid, 0, plan)
    buckets = BN254_G1.infinity((other.nw * other.nb,), card)
    for threads in (0, 3, 64, 512):  # nb = 32
        with pytest.raises(ValueError):
            M.reduce(BN254_G1, buckets, other.nw, other.nb, threads)
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
@pytest.mark.parametrize("n_bits", [254, 64])
def test_fixed_base_kernel_matches_plain_and_host(card, curve, n_bits):
    """B8 on edge and random scalars: 0, 1, r - 1, r (P == -Q in the top
    window), 2^248, all digits equal, 98 * 2^248 - r (P == Q in the top
    window)."""
    r = bn254.R
    base, add, mul = ((bn254.G1_GEN, bn254.g1_add, bn254.g1_mul) if curve.group == 1
                      else (bn254.G2_GEN, bn254.g2_add, bn254.g2_mul))
    if n_bits == 254:
        edge = [0, 1, r - 1, r, 1 << 248, int("15" * 32, 16), 98 * (1 << 248) - r]
    else:
        edge = [0, 1, (1 << 64) - 1, 1 << 56, int("15" * 8, 16)]
    rng = np.random.default_rng(n_bits)
    scal = edge + [int.from_bytes(rng.bytes(32), "big") % (1 << n_bits) for _ in range(300)]
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card)
    # the table is encoded by B1 launches once per device: make it before counting
    table = fixed_base_device_table(curve, base, n_bits, sc.device)
    _build.reset_counts()
    got = fixed_base_mul_batch(curve, base, sc, n_bits)
    assert _build.COUNTS == {f"fixed_base_g{curve.group}": 1}
    want = fixed_base_plain(curve, *table, sc, n_bits)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert curve.decode_jac(got) == [mul(base, k) for k in scal]


def test_merkle_tree_on_card_equals_cpu(card):
    """Poseidon (B1 launches) on the card gives the CPU tree, root and proofs."""
    rng = np.random.default_rng(3)
    addrs = [int.from_bytes(rng.bytes(20), "big") for _ in range(100)]
    bals = [int(x) for x in rng.integers(0, 2**63, size=100)]
    t_gpu = MerkleTree.build(addrs, bals, 8, device=card)
    t_cpu = MerkleTree.build(addrs, bals, 8, device="cpu")
    assert t_gpu.root() == t_cpu.root()
    for i in (0, 57, 99, 127):
        assert t_gpu.prove(i) == t_cpu.prove(i)


GATHERS = {"gather_rows": G.gather_rows, "gather_vec": G.gather_vec,
           "gather_async": G.gather_async}


@pytest.mark.parametrize("m", [0, 1, 7, 8, 1000])
@pytest.mark.parametrize("w", [8, 16, 128])
@pytest.mark.parametrize("kind", list(GATHERS))
def test_gather_kernels_match_index_select(card, kind, w, m):
    """E1-E3 on random and sorted indices with repeats: one launch each (none
    for M = 0), equal to index_select bit for bit. W = 8 and 128 take E1's
    16-byte pieces with rows narrower and wider than a warp's 32 pieces."""
    rng = np.random.default_rng(1000 * w + m)
    tab = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(300, w), dtype=np.int32)).to(card)
    idx = rng.integers(0, 300, size=m, dtype=np.int32)
    if m:
        idx[: m // 2 + 1] = idx[0]  # repeats
    for order in (idx, np.sort(idx)):
        t_idx = torch.from_numpy(order.copy()).to(card)
        _build.reset_counts()
        got = GATHERS[kind](tab, t_idx)
        torch.cuda.synchronize()
        assert _build.COUNTS == ({kind: 1} if m else {})
        assert tuple(got.shape) == (m, w) and got.is_cuda
        assert torch.equal(got, torch.index_select(tab, 0, t_idx))
        assert torch.equal(got, G.gather_rows_plain(tab, t_idx))


def test_gather_kernels_refuse_what_they_cannot_take(card):
    """E2 and E3 raise on a table that is not 16-byte aligned (no fallback
    to index_select), and E1 gathers it exactly through 4-byte pieces; E1
    and E2 gather a table above a block's 227 KB of shared memory exactly,
    one launch each."""
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(0, 4096, size=1000, dtype=np.int32)).to(card)
    idx[-1] = 4095
    big = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(4096, 16),
                                        dtype=np.int32)).to(card)  # 256 KiB
    flat = torch.arange(64 * 16 + 1, dtype=torch.int32, device=card)
    odd = flat[1:].view(64, 16)
    _build.reset_counts()
    for fn in (G.gather_vec, G.gather_async):
        with pytest.raises(ValueError):
            fn(odd, idx[:8] % 64)
    assert _build.COUNTS == {}
    got = G.gather_rows(odd, idx % 64)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"gather_rows": 1}
    assert torch.equal(got, torch.index_select(odd, 0, idx % 64))
    for kind in ("gather_rows", "gather_vec"):
        _build.reset_counts()
        got = GATHERS[kind](big, idx)
        torch.cuda.synchronize()
        assert _build.COUNTS == {kind: 1}
        assert torch.equal(got, torch.index_select(big, 0, idx))


@pytest.mark.parametrize("w", [1, 3, 5, 16, 33])
@pytest.mark.parametrize("m", [0, 1, 33, 1000, (1 << 16) + 3])
def test_gather_rows_any_width(card, w, m):
    """E1 at odd widths (4-byte pieces) and at W = 16 on aligned and
    unaligned tables, from a table above a block's 227 KB of shared
    memory, with a repeated row and the last row: one launch (none for
    M = 0), equal to gather_rows_plain limb for limb."""
    rng = np.random.default_rng(100 * w + m)
    t = (G.SMEM_OPTIN_MAX // (4 * w)) + 5
    flat = torch.from_numpy(rng.integers(-(2**31), 2**31, size=t * w + 1,
                                         dtype=np.int32)).to(card)
    idx = rng.integers(0, t, size=m, dtype=np.int32)
    if m:
        idx[m // 2] = idx[0]
        idx[-1] = t - 1
    t_idx = torch.from_numpy(idx).to(card)
    for tab in (flat[: t * w].view(t, w), flat[1:].view(t, w)):
        _build.reset_counts()
        got = G.gather_rows(tab, t_idx)
        torch.cuda.synchronize()
        assert _build.COUNTS == ({"gather_rows": 1} if m else {})
        assert tuple(got.shape) == (m, w)
        assert torch.equal(got, G.gather_rows_plain(tab, t_idx))


_TRAP = r"""
import sys, torch
from zkpoa_tpu_torch.ops import gather as G
tab = torch.zeros((9, 5), dtype=torch.int32, device="cuda")
idx = torch.tensor([0, int(sys.argv[1])], dtype=torch.int32, device="cuda")
try:
    G.gather_rows(tab, idx)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("refused:", e)
    sys.exit(3)
"""


@pytest.mark.parametrize("bad", [9, -1])
def test_gather_rows_traps_on_an_index_out_of_range(card, bad):
    """An index past the table or below 0 traps in the kernel (as
    index_select's device assert does); a trap ends the CUDA context, so it
    runs in a process of its own."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _TRAP, str(bad)], cwd=repo, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 3, (out.stdout, out.stderr)


@pytest.mark.parametrize("w,m", [(16, 31), (16, 33), (16, (1 << 14) + 5), (16, (1 << 20) + 5),
                                 (128, 31), (128, 33), (128, (1 << 14) + 5),
                                 (128, (1 << 16) + 5), (228, (1 << 12) + 5),
                                 (1024, 17), (1024, (1 << 12) + 5), (1812, (1 << 10) + 3),
                                 (G.ASYNC_W_MAX, 37)])
def test_gather_async_stages(card, w, m):
    """E3's stages: a partial stage alone (31), a whole one and a partial one
    (33), 513-514 stages (one warp a stage) and, at 2^20 + 5 rows of 64 B and
    2^16 + 5 rows of 512 B, more stages than the card holds warps, so each
    warp walks its ring round several times; a partial last stage every
    time. Rows above 224 words take 2 warps a block (228), then 16-row
    stages (1024, 1812) and at ASYNC_W_MAX one-row stages. One launch each,
    equal to index_select."""
    rng = np.random.default_rng(w + m)
    t = min(m, 1 << 16)
    tab = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(t, w), dtype=np.int32)).to(card)
    idx = rng.integers(0, t, size=m, dtype=np.int32)
    idx[min(31, m - 1)] = idx[min(32, m - 1)] = t - 1  # repeated across the first boundary
    t_idx = torch.from_numpy(idx).to(card)
    _build.reset_counts()
    got = G.gather_async(tab, t_idx)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"gather_async": 1}
    assert torch.equal(got, torch.index_select(tab, 0, t_idx))


@pytest.mark.parametrize("kind", ["gather_vec", "gather_async"])
def test_kernels_launch_on_the_current_stream(card, kind):
    """A launch goes to the stream current at the call: on a side stream,
    behind a sleep and a copy that writes the table, the gather reads the
    table as written, which it could not if it ran on another stream."""
    rng = np.random.default_rng(11)
    new = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(4096, 16), dtype=np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(0, 4096, size=1 << 14, dtype=np.int32)).to(card)
    tab = torch.zeros_like(new)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of the side stream
        tab.copy_(new)
        got = GATHERS[kind](tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.index_select(new, 0, idx))


def _jacobian_points(curve, pts, rng, device):
    """Host affine points (None = infinity) -> Jacobian Montgomery tensors
    (x l^2, y l^3, l), a random l per point; infinity as (l^2, l^3, 0)."""
    g2 = curve.group == 2
    mul = bn254.fp2_mul if g2 else (lambda a, b: a * b % bn254.P)
    xs, ys, zs = [], [], []
    for pt in pts:
        lam = int.from_bytes(rng.bytes(32), "big") % (bn254.P - 1) + 1
        lam = (lam, lam // 5) if g2 else lam
        l2 = mul(lam, lam)
        l3 = mul(l2, lam)
        inf = pt is None
        xs.append(l2 if inf else mul(pt[0], l2))
        ys.append(l3 if inf else mul(pt[1], l3))
        zs.append(((0, 0) if g2 else 0) if inf else lam)
    return tuple(curve.encode_coords(v, device) for v in (xs, ys, zs))


@pytest.mark.parametrize("c", [11, 5, 13])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_horner_kernel_matches_plain_and_host(card, curve, c):
    """msm_horner at the main path's shapes (G1 over four MSMs, G2 over one)
    equals horner_plain limb for limb and the host sum, with an infinity
    top window, T_w == res (a doubling inside the add), T_w == -res (res
    all-zero, then restarted), a whole MSM at infinity (G1); then 64 MSMs
    of random coordinates in one launch."""
    base, _add, mul = _group(curve)
    m = 4 if curve.group == 1 else 1
    wins = M.windows(c)
    nw = len(wins)
    rng = np.random.default_rng(40 + c)
    ks = [[int(x) for x in rng.integers(1, 2**62, size=nw)] for _ in range(m)]
    ks[0][nw - 1] = 0
    if m == 4:
        ks[2] = [0] * nw
    special = {(0, nw - 4): 1, (m - 1, nw - 7): -1, (m - 1, 2): 1}
    want = []
    for i in range(m):
        acc = ks[i][nw - 1]
        for w in range(nw - 2, -1, -1):
            acc = acc * (1 << wins[w][1]) % bn254.R
            if (i, w) in special:
                ks[i][w] = special[(i, w)] * acc % bn254.R
            acc = (acc + ks[i][w]) % bn254.R
        want.append(mul(base, acc) if acc else None)
    pts = [mul(base, k) if k else None for row in ks for k in row]
    tot = tuple(t.reshape((m, nw) + curve.coord_shape)
                for t in _jacobian_points(curve, pts, rng, card))
    _build.reset_counts()
    got = M.horner(curve, tot, c)
    torch.cuda.synchronize()
    assert _build.COUNTS == {f"msm_horner_g{curve.group}": 1}
    for a, b in zip(got, M.horner_plain(curve, tot, c)):
        assert torch.equal(a, b)
    assert curve.decode_jac(got) == want
    rand = tuple(_rand(curve.field, (64, nw) + curve.coord_shape[:-1], 50 + k + c).to(card)
                 for k in range(3))
    for a, b in zip(M.horner(curve, rand, c), M.horner_plain(curve, rand, c)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width,chunk", [(65536, None), (16, 4), (64, 64), (2, 2)])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_fold_kernel_matches_plain(card, curve, width, chunk):
    """point_fold over three segments of random coordinates with infinity
    lanes, P == Q and P == -Q pairs at the first level, one launch per
    chunk level, equal to fold_plain limb for limb."""
    n_seg = 3
    shape = (n_seg * width,) + curve.coord_shape[:-1]
    lanes = tuple(_rand(curve.field, shape, 60 + k).to(card) for k in range(3))
    ch = min(width, chunk or M.FOLD_CHUNK[curve.group])
    if width >= 4:
        half = ch // 2
        for t in lanes:
            t[half] = t[0]  # P == Q
        lanes[1][width + 1 + half] = L.sub_mod_plain(
            curve.field, torch.zeros_like(lanes[1][width + 1]), lanes[1][width + 1])
        lanes[0][width + 1 + half] = lanes[0][width + 1]
        lanes[2][width + 1 + half] = lanes[2][width + 1]  # P == -Q
        lanes[2][2 * width : 2 * width + width // 2] = 0  # infinity lanes
    _build.reset_counts()
    got = M.fold(curve, lanes, width, chunk)
    torch.cuda.synchronize()
    launches = len(M.fold_chunks(width, chunk or M.FOLD_CHUNK[curve.group]))
    assert _build.COUNTS == ({f"point_fold_g{curve.group}": launches} if launches else {})
    for a, b in zip(got, M.fold_plain(curve, lanes, width, chunk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_msm_many_heavy_sums_on_card(card, curve):
    """msm_many with two heavy values over two tables (one at a prefix
    pad): one Horner launch, at most two fold launches, one launch of the
    rounds kernel for the group and none of the elementwise B2, one copy
    to the host, then in the span `prove.msm.host` one counted host
    multiplication a table for the value 7 (none for 1); the totals equal
    the host MSMs and the heavy sums equal the CPU's."""
    base, add, mul = _group(curve)
    n, pad = 600, 40
    table, pts = _table(curve, base, add, mul, n, 70)
    sub = type(table)(table.xs[pad:], table.ys[pad:], table.valid[pad:])
    rng = np.random.default_rng(71)
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    scal[0:560:2] = [1] * 280
    scal[1:560:2] = [7] * 280
    plan = M.plan_msm(torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card), 6)
    assert sorted(v for v, _ in plan.heavy) == [1, 7]
    _build.reset_counts()
    with trace.collect() as events:
        got = M.msm_many(curve, [(table, plan, 0), (sub, plan, pad)])
    g = curve.group
    assert _build.COUNTS[f"msm_horner_g{g}"] == 1
    assert 1 <= _build.COUNTS[f"point_fold_g{g}"] <= 2
    assert _build.COUNTS[f"heavy_rounds_g{g}"] == 1  # every segment of the group in one launch
    assert f"point_add_affine_g{g}" not in _build.COUNTS
    assert f"point_add_g{g}" not in _build.COUNTS and f"point_double_g{g}" not in _build.COUNTS
    assert [(e["name"], e["site"], e["n"]) for e in events if e["kind"] == "count"] == \
        [("host_sync", f"msm_decode_g{g}", 1)] + [("host_mul", f"heavy_g{g}", 1)] * 2
    assert [e["name"] for e in events if e["kind"] == "span"] == ["prove.msm.host"]
    for k, off in enumerate((0, pad)):
        want = None
        for i, s in enumerate(scal):
            if i >= off and pts[i] is not None:
                want = add(want, mul(pts[i], s))
        assert got[k] == want
    segs = [(table, sel, 0) for _v, sel in plan.heavy] + [(sub, sel, pad) for _v, sel in plan.heavy]
    cpu = lambda t: type(t)(t.xs.cpu(), t.ys.cpu(), t.valid.cpu())  # noqa: E731
    segs_cpu = [(cpu(t), sel.cpu(), off) for t, sel, off in segs]
    for block, chunk in ((M.TREE_BLOCK, None), (64, 4)):
        on_card = M.tree_sum_many(curve, segs, block, chunk)
        assert curve.decode_jac(on_card) == curve.decode_jac(
            M.tree_sum_many(curve, segs_cpu, block, chunk))


# host waits PyTorch's sync debug mode cannot see: torch.unique waits for
# its output size inside thrust, past the hooks the mode reports from
UNSEEN_SYNCS = {"plan.unique"}


def _syncs_against_sync_debug(fn):
    """(host_sync counts by site, the waits PyTorch's sync debug mode
    reports from the package's own lines, by file:line) of fn(). Reports
    from other frames are left out: the first switch to "warn" in a
    process reports one at the switch itself."""
    with warnings.catch_warnings(record=True) as caught, trace.collect() as events:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted, reported, elsewhere = {}, {}, {}
    for e in events:
        if e["kind"] == "count" and e["name"] == "host_sync":
            counted[e["site"]] = counted.get(e["site"], 0) + e["n"]
    for w in caught:
        if "synchroniz" in str(w.message):
            mine = "zkpoa_tpu_torch" in w.filename
            k = f"{w.filename.rsplit('/', 2)[-1] if mine else w.filename}:{w.lineno}"
            out = reported if mine else elsewhere
            out[k] = out.get(k, 0) + 1
    print(json.dumps({"counted": counted, "reported": reported, "elsewhere": elsewhere},
                     sort_keys=True))
    return counted, reported


def _seen(counted):
    return sum(n for site, n in counted.items() if site not in UNSEEN_SYNCS)


@pytest.fixture(scope="module")
def layer_one(card):
    """A 2-signature layer-one system, its witness and a development key,
    proved once so the kernels are built and the constants on the card."""
    from zkpoa_tpu_torch.models.layers import LayerOneInput, layer_one_circuit
    from zkpoa_tpu_torch.pipeline.fixtures import generate_signatures
    from zkpoa_tpu_torch.pipeline.sigs import layer_one_input, parse_signatures

    inp = layer_one_input(parse_signatures(generate_signatures(2, "sync-debug")))
    system, witness = layer_one_circuit(
        [LayerOneInput.from_json_entry(inp, i) for i in range(2)]).compile()
    key = setup_device(system, "cuda", seed="sync-debug|key")
    prove(key, system, witness, "cuda", r=1, s=2)
    torch.cuda.synchronize()
    return key, system, witness


def test_host_syncs_of_a_prove_are_what_sync_debug_reports(layer_one):
    """Every place a layer-one prove waits on the card is counted once as
    `host_sync` (`host_syncs.prove` reads these counts): the waits the
    sync debug mode reports, and the one of torch.unique that it cannot
    see. Without `log` the prove makes no phase synchronize."""
    key, system, witness = layer_one
    counted, reported = _syncs_against_sync_debug(
        lambda: prove(key, system, witness, "cuda", r=3, s=4))
    assert "prove.phase" not in counted and "plan.max_pieces" not in counted
    assert counted["plan.combine"] >= 2  # the witness and h plans, each in its combine alone
    assert counted["plan.heavy_rows"] > 0  # layer one has heavy values
    assert counted["plan.unique"] == 1  # the witness plan; the h plan splits nothing
    assert _seen(counted) == sum(reported.values()), (counted, reported)


def test_a_prove_on_the_card_copies_its_witness_alone(layer_one):
    """After the fixture's setup and first prove, the SpMV operands live on
    the card with the packed system as int32 tensors and a prove copies
    only its witness. Its SpMV gives the CPU's evaluations of the same
    witness limb for limb, and its proof verifies (a whole CPU prove of
    layer one runs for over fifteen minutes)."""
    from zkpoa_tpu_torch.ops.qap_eval import eval_matrices_device

    key, system, witness = layer_one
    with trace.collect() as events:
        proof = prove(key, system, witness, "cuda", r=7, s=8)
    counted = {}
    for e in events:
        if e["kind"] == "count" and e["name"] in ("h2d_bytes", "spmv_operands"):
            counted[e["name"], e["site"]] = counted.get((e["name"], e["site"]), 0) + e["n"]
    assert counted == {("h2d_bytes", "witness"): 32 * len(witness), ("spmv_operands", "hit"): 1}
    packed = system.pack()
    assert [d.type for d in packed._spmv_operands] == ["cuda"]
    (mats, pool), = packed._spmv_operands.values()
    for t in (t for mat in mats for t in mat):
        assert t.is_cuda and t.dtype == torch.int32
    assert pool.is_cuda
    limbs = torch.from_numpy(host.witness_limbs(witness)[0])
    on_card = eval_matrices_device(packed, limbs.cuda(), key.domain_size)
    on_cpu = eval_matrices_device(packed, limbs, key.domain_size)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(got.cpu(), want)
    vk = groth16.VerifyingKey.from_json(key.vk_json)
    assert groth16.verify(vk, proof, [witness[w] for w in range(1, system.n_public + 1)])


def test_host_syncs_of_a_plan_without_heavy_values_are_what_sync_debug_reports(card):
    """A plan whose scalars repeat no value: the heavy-value search waits
    once (its empty copy to the host does not wait)."""
    rng = np.random.default_rng(72)
    scal = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(4096)]
    limbs = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card)
    torch.cuda.synchronize()
    counted, reported = _syncs_against_sync_debug(lambda: M.plan_msm(limbs, 6))
    assert counted["plan.heavy_values"] == 1 and "plan.heavy_rows" not in counted
    assert counted["plan.unique"] == 1
    # about 128 entries a bucket, so fewer pieces than COMBINE_FAN_IN: one combine level, one read
    assert counted["plan.combine"] == 1 and "plan.max_pieces" not in counted
    assert _seen(counted) == sum(reported.values()), (counted, reported)


def test_horner_and_fold_refuse_what_they_cannot_take(card):
    tot = BN254_G1.infinity((2, 10), card)  # c = 11 has 24 windows
    with pytest.raises(ValueError):
        M.horner(BN254_G1, tot, 11)
    lanes = BN254_G1.infinity((48,), card)
    with pytest.raises(ValueError):
        M.fold(BN254_G1, lanes, 32)  # 48 lanes are not whole segments of 32
    with pytest.raises(ValueError):
        M.fold(BN254_G1, BN254_G1.infinity((2048,), card), 1024, 1024)
    assert len(M.horner(BN254_G1, BN254_G1.infinity((0, 24), card), 11)[0]) == 0


def test_mont_chain_probe_matches_plain(card):
    """The latency probe of chip_smoke.py: a chain of products equals the
    same chain of plain products."""
    a = _rand(L.BN254_FQ, (2,), 80).to(card)
    x = a[0]
    for _ in range(64):
        x = L.mont_mul_plain(L.BN254_FQ, x, a[1])
    assert torch.equal(FK.mont_chain(a[0], a[1], 64), x)


def _field_edges(p):
    """Canonical carry-heavy values and operands that are not canonical but
    keep a product inside a.b < 2^256 p (as chip_smoke.py phase 3)."""
    canon = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, p - (1 << 32), (1 << 255) % p]
    canon += [(1 << (32 * k)) - 1 for k in range(1, 8)]
    wide = [(1 << 256) - 1, (1 << 256) - p, p, p + 1, 2 * p - 1, 1 << 255,
            (1 << 256) - (1 << 224)]
    return canon, wide


@pytest.mark.parametrize("which", ["fq", "fr"])
def test_field_core_on_carry_heavy_edge_cases(card, which):
    """The PTX carry chains of field.cuh on every pair of edge values (a - b
    = 0, a < b, a + b just under, at and just over p, all-ones limbs) and
    on products with one non-canonical operand: equal to the plain
    versions and to host integers."""
    spec = L.BN254_FQ if which == "fq" else L.BN254_FR
    p = spec.modulus
    rinv = pow(1 << 256, -1, p)
    canon, wide = _field_edges(p)
    lim = lambda v: torch.from_numpy(host.scalars_to_limbs_fast(v)).to(card)  # noqa: E731
    pairs = [(x, y) for x in canon for y in canon]
    a, b = lim([x for x, _ in pairs]), lim([y for _, y in pairs])
    for op, plain, fn in ((FK.OP_MUL, L.mont_mul_plain, lambda x, y: x * y * rinv % p),
                          (FK.OP_ADD, L.add_mod_plain, lambda x, y: (x + y) % p),
                          (FK.OP_SUB, L.sub_mod_plain, lambda x, y: (x - y) % p)):
        got = FK.field_binop(spec, op, a, b)
        assert torch.equal(got, plain(spec, a, b))
        assert spec.from_limbs(got) == [fn(x, y) for x, y in pairs]
    wp = [(x, y) for x in wide for y in canon + wide if x * y < (p << 256)]
    wp += [(y, x) for x, y in wp]
    wa, wb = lim([x for x, _ in wp]), lim([y for _, y in wp])
    got = FK.field_binop(spec, FK.OP_MUL, wa, wb)
    assert torch.equal(got, L.mont_mul_plain(spec, wa, wb))
    assert spec.from_limbs(got) == [x * y * rinv % p for x, y in wp]
    if which == "fq":  # the chains inside a point formula: doublings of edge coordinates
        pts = tuple(lim(canon[k:] + canon[:k]) for k in range(3))
        got = FK.point_double(1, pts)
        for x, y in zip(got, run_plain(BN254_G1.arith(card), jac_double, pts)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("log_n", [1, 4, 10, 11, 12, 21, 22, 23, 24])
def test_ntt_kernel_matches_plain(card, log_n, inverse, monkeypatch):
    """The pass kernel equals the per-stage plain version limb for limb, in
    ceil(log_n / TILE_LOG) launches (three passes from 2^23, the recursive
    layers' domains); and its schedule twin in tiles of 2^3."""
    from zkpoa_tpu_torch.ops import ntt as N

    gen = torch.Generator(device="cuda")
    gen.manual_seed(log_n)
    n = 1 << log_n
    x = L.to_i32(torch.randint(0, 2**32, (n, 8), generator=gen, device=card, dtype=torch.int64))
    x[:, 7] &= 0x0FFFFFFF  # canonical: below 2^252 < r
    N.ntt(x, inverse)  # the twiddle table is built by B1 launches once per device and size
    _build.reset_counts()
    got = N.ntt(x, inverse)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"ntt_pass": -(-log_n // N.TILE_LOG)}
    assert torch.equal(got, N.ntt_plain(x, inverse))
    if log_n <= 12:
        scale = L.BN254_FR.encode([pow(n, -1, bn254.R)], card) if inverse else None
        monkeypatch.setattr(N, "TILE_LOG", 3)
        assert torch.equal(N.ntt_kernel(x, inverse, scale),
                           N.ntt_passes_plain(x, inverse, scale))


@pytest.mark.parametrize("log_n", [4, 10, 12])
def test_quotient_on_card_equals_cpu(card, log_n):
    """quotient and coset_qap_evals through the pass kernel (folded scales)
    equal the CPU's schedule twin; 7 and 6 transforms of ceil(log_n / 11)
    passes, with 2 B1 launches (A*B, - C) besides."""
    from zkpoa_tpu_torch.ops import ntt as N

    rng = np.random.default_rng(log_n)
    ev = [L.BN254_FR.encode([int.from_bytes(rng.bytes(32), "big") % bn254.R
                             for _ in range(1 << log_n)], "cpu") for _ in range(3)]
    ev_card = [v.to(card) for v in ev]
    N.quotient(*ev_card)  # tables are built by B1 launches once per device and size
    N.coset_qap_evals(*ev_card)
    passes = -(-log_n // N.TILE_LOG)
    for fn, transforms in ((N.quotient, 7), (N.coset_qap_evals, 6)):
        _build.reset_counts()
        got = fn(*ev_card)
        torch.cuda.synchronize()
        assert _build.COUNTS == {"ntt_pass": transforms * passes, "field_mont_mul": 1,
                                 "field_sub_mod": 1}
        assert torch.equal(got.cpu(), fn(*ev))


def test_ntt_kernel_refuses_what_it_cannot_take(card):
    from zkpoa_tpu_torch.ops import ntt as N

    x = torch.zeros((16, 8), dtype=torch.int32, device=card)
    _build.reset_counts()
    with pytest.raises(ValueError):
        N.ntt_kernel(x[:12])
    with pytest.raises(ValueError):
        N.ntt_kernel(x[::2])  # not contiguous
    with pytest.raises(ValueError):
        N.ntt_kernel(x, scale=x[:4])
    with pytest.raises(ValueError):
        N.ntt_kernel(x, scale=x.cpu())
    assert _build.COUNTS == {}


class _Rows:
    def __init__(self, xs, ys, valid):
        self.xs, self.ys, self.valid = xs, ys, valid


def _rounds_edge_case(curve, device):
    """Segments (table, idx, offset) with W = 16, as in
    tests/test_torch_row_accum.py: 37 entries with P == Q (lane 0) and
    P == -Q (lane 1) inside a lane, an index past the table and a row that
    is not valid; exactly W entries at an offset with indices before it;
    an empty segment; only absent rows; an empty table; 20 entries with
    P == Q in lane 2. Returns the segments and the host sums."""
    base, add, mul = _group(curve)
    neg = bn254.g1_neg if curve.group == 1 else bn254.g2_neg
    rng = np.random.default_rng(81)
    pts = [mul(base, int(k)) for k in rng.integers(1, 2**40, size=40)]
    pts[7] = neg(pts[6])
    pts[11] = None
    pts2 = pts[::-1]
    t1 = _Rows(*curve.encode_affine(pts, device))
    t2 = _Rows(*curve.encode_affine(pts2, device))
    t0 = _Rows(*curve.encode_affine([], device))
    idx0 = [int(i) for i in rng.integers(0, 40, size=37)]
    idx0[0], idx0[16], idx0[1], idx0[17], idx0[33] = 5, 5, 6, 7, 9
    idx0[4], idx0[20] = 45, 11
    idx1 = [0, 1, 2] + [int(i) + 3 for i in rng.integers(0, 40, size=13)]
    idx5 = [int(i) + 3 for i in rng.integers(0, 40, size=20)]
    idx5[2] = idx5[18] = 23
    segs = [(t1, idx0, 0), (t2, idx1, 3), (t1, [], 0), (t1, [11, 40, 51], 0), (t0, [0, 1], 0),
            (t2, idx5, 3)]
    tab_pts = {id(t1): pts, id(t2): pts2, id(t0): []}
    want = []
    for t, idx, off in segs:
        acc = None
        for i in idx:
            r = i - off
            if 0 <= r < len(tab_pts[id(t)]) and tab_pts[id(t)][r] is not None:
                acc = add(acc, tab_pts[id(t)][r])
        want.append(acc)
    segments = [(t, torch.tensor(i, dtype=torch.int64, device=device), off) for t, i, off in segs]
    return segments, want


def _cpu_segments(segments):
    return [(_Rows(t.xs.cpu(), t.ys.cpu(), t.valid.cpu()), idx.cpu(), off)
            for t, idx, off in segments]


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_heavy_rounds_kernel_matches_plain_on_edge_cases(card, curve):
    """The rounds kernel (csrc/heavy_rounds.cu) on the edge-case segments:
    one launch, lanes equal to heavy_rounds_plain's on the CPU limb for
    limb, and tree_sum_many's sums equal to the host sums."""
    segments, want = _rounds_edge_case(curve, card)
    _build.reset_counts()
    lanes = M.heavy_rounds(curve, segments, 16)
    torch.cuda.synchronize()
    assert _build.COUNTS == {f"heavy_rounds_g{curve.group}": 1}
    for a, b in zip(lanes, M.heavy_rounds_plain(curve, _cpu_segments(segments), 16)):
        assert torch.equal(a.cpu(), b)
    assert curve.decode_jac(M.tree_sum_many(curve, segments, block=16)) == want


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_heavy_rounds_kernel_at_the_prove_shape(card, curve):
    """W = 2^16 lanes a segment, as a warm prove: random coordinates, three
    tables (the third a suffix of the first at a prefix pad, as the
    c-query), runs of 150000, 65536, 3000 and 300 sorted indices per table
    with rows out of range and rows not valid, P == Q planted in lane 0;
    one launch, equal to the plain version on the card."""
    n, pad = 1 << 18, 40
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    shape = (n,) + curve.coord_shape[:-1]
    xs = _rand(curve.field, shape, 91).to(card)
    ys = _rand(curve.field, shape, 92).to(card)
    valid = torch.rand(n, generator=gen, device=card) > 0.01
    tabs = [_Rows(xs, ys, valid), _Rows(xs.flip(0).contiguous(), ys.flip(0).contiguous(), valid),
            _Rows(xs[pad:], ys[pad:], valid[pad:])]
    segments = []
    for k, table in enumerate(tabs):
        for m in (150000, 65536, 3000, 300):
            idx = torch.randperm(n + 50, generator=gen, device=card)[:m].sort().values
            if m == 150000:
                idx[65536] = idx[0]  # lane 0 adds the same row twice: P == Q
            segments.append((table, idx, pad if k == 2 else 0))
    _build.reset_counts()
    got = M.heavy_rounds(curve, segments, 1 << 16)
    torch.cuda.synchronize()
    assert _build.COUNTS == {f"heavy_rounds_g{curve.group}": 1}
    for a, b in zip(got, M.heavy_rounds_plain(curve, segments, 1 << 16)):
        assert torch.equal(a, b)


def test_heavy_rounds_splits_past_its_launch_limits(card):
    """70 segments over 10 tables take more than one launch (at most
    ROUNDS_MAX_SEGS segments over ROUNDS_MAX_TABLES tables each) and give
    the plain version's lanes."""
    curve = BN254_G1
    tabs = [_Rows(_rand(curve.field, (50,), 100 + k).to(card),
                  _rand(curve.field, (50,), 200 + k).to(card),
                  torch.ones(50, dtype=torch.bool, device=card)) for k in range(10)]
    rng = np.random.default_rng(7)
    segments = [(tabs[k % 10], torch.tensor(rng.integers(0, 55, size=int(rng.integers(0, 20))),
                                            dtype=torch.int64, device=card), k % 3)
                for k in range(70)]
    keys = [(t.xs.data_ptr(), t.ys.data_ptr(), t.valid.data_ptr(), 50) for t, _i, _o in segments]
    _build.reset_counts()
    got = M.heavy_rounds(curve, segments, 8)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"heavy_rounds_g1": len(M._rounds_launches(keys))} and \
        len(M._rounds_launches(keys)) > 1
    for a, b in zip(got, M.heavy_rounds_plain(curve, segments, 8)):
        assert torch.equal(a, b)


def test_heavy_rounds_refuses_what_it_cannot_take(card):
    """A CUDA table takes the kernel or raises: indices of another dtype or
    device, a table of another dtype, a non-contiguous table, a valid mask
    that does not match the table, a width that is not a power of two; no
    launch is counted."""
    curve = BN254_G1
    xs = _rand(curve.field, (64,), 1).to(card)
    ys = _rand(curve.field, (64,), 2).to(card)
    valid = torch.ones(64, dtype=torch.bool, device=card)
    idx = torch.arange(20, dtype=torch.int64, device=card)
    bad = [
        [(_Rows(xs, ys, valid), idx.to(torch.int32), 0)],
        [(_Rows(xs, ys, valid), idx.cpu(), 0)],
        [(_Rows(xs.to(torch.int64), ys, valid), idx, 0)],
        [(_Rows(xs[::2], ys[::2], valid[::2]), idx, 0)],
        [(_Rows(xs, ys, valid[:63]), idx, 0)],
        [(_Rows(xs, ys[:63], valid), idx, 0)],
        [(_Rows(xs, ys, valid), idx[::2], 0)],
    ]
    _build.reset_counts()
    for segments in bad:
        with pytest.raises(ValueError):
            M.heavy_rounds(curve, segments, 16)
    with pytest.raises(ValueError):
        M.heavy_rounds(curve, [(_Rows(xs, ys, valid), idx, 0)], 12)
    assert _build.COUNTS == {}


@pytest.mark.parametrize("n", [1003, 1 << 16])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_fixed_base_kernel_on_sparse_and_ragged_scalars(card, curve, n):
    """B8 where most scalars are zero (whole warps vote every window out),
    small scalars (one non-zero digit), and counts that fill neither a G1
    warp (32 lanes) nor a G2 warp of triples (10): equal to the plain
    version, and decoded to host multiples. G2 takes both lane layouts: 1003
    scalars fit one wave of triples, 2^16 take a thread a scalar."""
    base, add, mul = _group(curve)
    rng = np.random.default_rng(9)
    scal = [0] * n
    for i in range(0, n, 37):
        scal[i] = int.from_bytes(rng.bytes(32), "big") % bn254.R
    scal[500:520] = [int(k) for k in rng.integers(1, 256, size=20)]
    scal[-1] = bn254.R - 1
    sc = torch.from_numpy(host.scalars_to_limbs_fast(scal)).to(card)
    table = fixed_base_device_table(curve, base, 254, sc.device)
    _build.reset_counts()
    got = fixed_base_mul_batch(curve, base, sc, 254)
    assert _build.COUNTS == {f"fixed_base_g{curve.group}": 1}
    for a, b in zip(got, fixed_base_plain(curve, *table, sc, 254)):
        assert torch.equal(a, b)
    pick = [0, 1, 37, 500, 519, n - 1]
    assert curve.decode_jac(tuple(t[pick] for t in got)) == [
        mul(base, scal[i]) if scal[i] else None for i in pick]


def _wrapping_scalar(sign):
    """A scalar below 2^254 whose last window add meets P == Q (sign 1) or
    P == -Q (sign -1): k = a 2^w + d, a 2^w = sign d mod r (as in
    tests/test_torch_scalar_mul.py)."""
    w = FK.LADDER_W
    inv, h = pow(1 << w, -1, bn254.R), 1 << (w - 1)
    for d in [*range(1, h + 1), *range(-h, 0)]:
        a = sign * d * inv % bn254.R
        if a < (1 << (254 - w)) - 1:
            return (a << w) + d
    raise AssertionError("no wrapping scalar below 2^254")


def _ladder_inputs(curve, n, seed, card):
    """Points P_i = [g_i] G (Jacobian from B8, z not 1), one at infinity,
    and scalars 0, 1, 2, r - 1, 2^64 - 1, 2^254 - 1, two that wrap mod r
    in the last window (P == Q, P == -Q), then random 254-bit ones."""
    base, add, mul = _group(curve)
    rng = np.random.default_rng(seed)
    g = [int.from_bytes(rng.bytes(32), "big") % bn254.R for _ in range(n)]
    p = fixed_base_mul_batch(curve, base,
                             torch.from_numpy(host.scalars_to_limbs_fast(g)).to(card), 254)
    p = tuple(t.contiguous() for t in p)
    if n > 5:
        p[2][5] = 0  # P_5 at infinity (its x and y stay as they were)
    ks = [0, 1, 2, bn254.R - 1, (1 << 64) - 1, (1 << 254) - 1, _wrapping_scalar(1),
          _wrapping_scalar(-1)] + [int.from_bytes(rng.bytes(32), "big") % bn254.R
                                   for _ in range(n - 8)]
    ks = ks[:n]
    return g, p, ks, torch.from_numpy(host.scalars_to_limbs_fast(ks)).to(card)


@pytest.mark.parametrize("form", ["lanes", "one"])
@pytest.mark.parametrize("n", [1, 1003, 1 << 14])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_scalar_mul_kernel_matches_plain_and_host(card, curve, n, form):
    """K1: one launch, limbs equal to the plain ladder, decoded points
    equal to host multiples; a scalar a lane, or one scalar [8] for every
    lane (the 1/m scale's and a contribution's form). G2 runs on the
    `G2Tri` triple layout (three threads a lane) at every lane count."""
    from zkpoa_tpu_torch.ops.curve import scalar_mul_batch, scalar_mul_plain

    base, _add, mul = _group(curve)
    g, p, ks, sc = _ladder_inputs(curve, n, 11 + n, card)
    if form == "one":
        ks = [_wrapping_scalar(1)] * n
        sc = torch.from_numpy(host.scalars_to_limbs_fast(ks[:1])[0]).to(card)
    _build.reset_counts()
    got = scalar_mul_batch(curve, p, sc, 254)
    torch.cuda.synchronize()
    assert _build.COUNTS == {f"scalar_mul_g{curve.group}": 1}
    for a, b in zip(got, scalar_mul_plain(curve, p, sc, 254)):
        assert torch.equal(a, b)
    pick = sorted({0, n // 2, n - 1} | ({3, 4, 5, 6, 7} if n > 7 else set()))
    want = [None if (i == 5 and n > 5) else mul(base, g[i] * ks[i] % bn254.R) for i in pick]
    assert curve.decode_jac(tuple(t[pick] for t in got)) == want


@pytest.mark.parametrize("log_half", [0, 1, 5, 9])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=["g1", "g2"])
def test_group_ntt_stage_kernel_matches_plain(card, curve, log_half):
    """K2 on 1024 points (in place, one launch) against the plain stage:
    512 / half blocks, from 512 (every twiddle 1) to one (the top stage);
    the twiddle table starts with 1, as every stage's does."""
    from zkpoa_tpu_torch.ops.curve import booth_digits
    from zkpoa_tpu_torch.ops.group_ntt import stage, stage_plain

    _g, p, _ks, sc = _ladder_inputs(curve, 1024, 21 + log_half, card)
    tw = sc[: 1 << log_half].clone()
    tw[0] = torch.tensor(host.scalars_to_limbs_fast([1])[0], device=card)
    digits = booth_digits(tw)
    want = stage_plain(curve, p, digits, log_half)
    _build.reset_counts()
    got = stage(curve, tuple(t.clone() for t in p), digits, log_half)
    torch.cuda.synchronize()
    assert _build.COUNTS == {f"group_ntt_stage_g{curve.group}": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ceremony_setup_on_card_equals_cpu(card, tmp_path):
    """The dev ceremony, its Lagrange points and a contributed ceremony key
    on the card equal the CPU's (plain versions) table for table."""
    from zkpoa_tpu_torch.prover import ptau as P

    c = Circuit()
    out = c.public_output()
    x, y = c.var(5), c.var(9)
    c.bind_output(out, c.mul(x, y) * 3 + x - 7)
    r1cs, wit = c.compile()
    path = str(tmp_path / "dev.ptau")
    P.write_dev_ptau(path, 4, seed="card", device="cuda")
    cpu_path = str(tmp_path / "cpu.ptau")
    P.write_dev_ptau(cpu_path, 4, seed="card", device="cpu")
    with open(path, "rb") as f, open(cpu_path, "rb") as g:
        assert f.read() == g.read()
    pt = P.read_ptau(path, "cuda")
    assert P.verify_ptau(pt)
    lag = BN254_G2.decode_jac(P._lagrange_g2(pt["tau_g2"], 16))
    assert lag == BN254_G2.decode_jac(P._lagrange_g2(P.read_ptau(path, "cpu")["tau_g2"], 16))
    keys = []
    for device in ("cuda", "cpu"):
        keys.append(P.beacon(P.contribute(P.setup_from_ptau(r1cs, path, device), "e"), "h"))
    gpu, cpu = keys
    for name in ("a_query", "b1_query", "c_query", "h_query", "b2_query"):
        tg, tc = getattr(gpu, name), getattr(cpu, name)
        for k in ("xs", "ys", "valid"):
            assert torch.equal(getattr(tg, k).cpu(), getattr(tc, k)), name
    assert gpu.vk_json == cpu.vk_json
    proof = prove(gpu, r1cs, wit, "cuda", seed="ptau")
    vk = groth16.VerifyingKey.from_json(gpu.vk_json)
    assert groth16.verify(vk, proof, [wit[w] for w in range(1, r1cs.n_public + 1)])


def test_ladder_launchers_refuse_what_they_cannot_take(card):
    from zkpoa_tpu_torch.ops.curve import booth_digits

    _g, p, _ks, sc = _ladder_inputs(BN254_G1, 8, 5, card)
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, p, sc[:7], 254)  # one scalar short
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, p, sc[:2], 254)  # neither a scalar a lane nor one
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, p, sc[:1].reshape(1, 1, 8), 254)  # one scalar, but [1, 1, 8]
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, p, sc, 0)
    with pytest.raises(ValueError):
        FK.group_ntt_stage(FK.G1, p, booth_digits(sc[:3]), 1)  # digits must be [half, nd]
    with pytest.raises(ValueError):
        FK.group_ntt_stage(FK.G1, p, sc[:2], 1)  # twiddle limbs, not digits
    with pytest.raises(ValueError):
        FK.group_ntt_stage(FK.G1, p, booth_digits(sc[:2], 254, FK.LADDER_W + 1), 1)  # other w
    with pytest.raises(ValueError):
        FK.group_ntt_stage(FK.G1, tuple(t[:6] for t in p), booth_digits(sc[:4]),
                           2)  # 2 half does not divide
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, tuple(t.reshape(-1)[1:57].reshape(7, 8) for t in p),
                      sc[:7], 254)  # not 16-byte aligned
    with pytest.raises(ValueError):
        FK.scalar_mul(FK.G1, p, sc.reshape(-1)[1:9], 254)  # one scalar, not 16-byte aligned


@pytest.mark.parametrize("shape,inverse", [((3, 1 << 4), False), ((2, 3, 1 << 5), True),
                                           ((2, 1 << 12), True), ((1 << 11, 1 << 10), False),
                                           ((65537, 2), True)],
                         ids=["3x2^4", "2x3x2^5-inv", "2x2^12-inv", "2^11x2^10", "65537x2-inv"])
def test_batched_ntt_kernel_matches_plain(card, shape, inverse, monkeypatch):
    """A batch [..., n, 8] in one launch a pass (the grid's second dimension
    over the transforms, folded into the first past 65,535), the scale table
    shared; equal to the plain schedule on the batch and to each transform
    alone, also in tiles of 2^3."""
    from zkpoa_tpu_torch.ops import ntt as N

    gen = torch.Generator(device="cuda")
    gen.manual_seed(len(shape))
    n = shape[-1]
    x = L.to_i32(torch.randint(0, 2**32, shape + (8,), generator=gen, device=card,
                               dtype=torch.int64))
    x[..., 7] &= 0x0FFFFFFF  # canonical: below 2^252 < r
    scale = N.pow_table(5, n, card, scale=pow(n, -1, bn254.R))
    N.ntt_kernel(x, inverse, scale)  # the twiddle table is built by B1 launches once
    _build.reset_counts()
    got = N.ntt_kernel(x, inverse, scale)
    torch.cuda.synchronize()
    log_n = n.bit_length() - 1
    assert _build.COUNTS == {"ntt_pass": -(-log_n // N.TILE_LOG)}
    assert torch.equal(got, N.ntt_passes_plain(x, inverse, scale))
    flat = x.reshape(-1, n, 8)
    for i in (0, flat.shape[0] - 1):
        assert torch.equal(got.reshape(-1, n, 8)[i], N.ntt_kernel(flat[i].contiguous(), inverse,
                                                                  scale))
    if log_n > 3:
        monkeypatch.setattr(N, "TILE_LOG", 3)
        assert torch.equal(N.ntt_kernel(x, inverse, scale), N.ntt_passes_plain(x, inverse, scale))


@pytest.fixture
def one_rank_nccl(card, tmp_path):
    """A one-rank NCCL process group (file store in tmp_path), destroyed after."""
    import torch.distributed as dist

    from zkpoa_tpu_torch.parallel import mesh as PM

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    assert PM.init_multihost(device="cuda") == 1  # a group is up: nothing to start
    yield PM
    dist.destroy_process_group()


def test_one_rank_nccl_quotient_dist_and_prove_batched(one_rank_nccl, card):
    """quotient_dist at 2^12 on a one-rank "data" mesh equals ops.ntt's
    quotient limb for limb; prove_batched of two toy witnesses on a one-rank
    "batch" mesh equals sequential prove with seeds f"bp-b{i}" and verifies;
    the stacked quotient is one launch a pass for both witnesses."""
    from zkpoa_tpu_torch.ops import ntt as N
    from zkpoa_tpu_torch.parallel import batch_prove, ntt_dist

    PM = one_rank_nccl
    rng = np.random.default_rng(12)
    ev = [L.BN254_FR.encode([int.from_bytes(rng.bytes(32), "big") % bn254.R
                             for _ in range(1 << 12)], card) for _ in range(3)]
    assert torch.equal(ntt_dist.quotient_dist(*ev, PM.make_mesh(1, "data")), N.quotient(*ev))

    def toy(x, y):
        c = Circuit()
        out = c.public_output()
        c.bind_output(out, poseidon(c, [c.var(x), c.var(y)]))
        return c.compile()

    (r1cs, w0), (_, w1) = toy(7, 11), toy(13, 17)
    pk = setup_device(r1cs, "cuda", seed="batchkey")
    _build.reset_counts()
    proofs = batch_prove.prove_batched(pk, r1cs, [w0, w1], PM.make_mesh(1, "batch"), seed="bp")
    passes = -(-(pk.domain_size.bit_length() - 1) // N.TILE_LOG)
    assert _build.COUNTS["ntt_pass"] == 7 * passes
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    for i, (proof, wit) in enumerate(zip(proofs, [w0, w1])):
        want = prove(pk, r1cs, wit, "cuda", seed=f"bp-b{i}")
        assert proof.to_json() == want.to_json()
        assert groth16.verify(vk, proof, [wit[w] for w in range(1, r1cs.n_public + 1)])


def test_eth_addresses_batch_on_card_equals_cpu_and_host(card):
    from zkpoa_tpu_torch.ops import keccak as K

    rng = np.random.default_rng(9)
    pubs = [(int.from_bytes(rng.bytes(32), "big"), int.from_bytes(rng.bytes(32), "big"))
            for _ in range(1000)]
    got = K.eth_addresses_batch(pubs)
    assert got == K.eth_addresses_batch(pubs, device="cpu")
    assert got[:64] == [K.eth_address(p) for p in pubs[:64]]
    msgs = rng.integers(0, 256, size=(7, 135), dtype=np.uint8)
    assert torch.equal(K.keccak256_fixed_batch(msgs).cpu(), K.keccak256_fixed_batch(msgs, "cpu"))
