"""zkpoa_tpu_torch CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA card and skips without one. The port does
not need JAX, so this file imports neither JAX nor the JAX package, and on
a machine without JAX it runs without the test directory's conftest (which
sets JAX up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are made with numpy / torch from fixed seeds. Tolerance: exact
equality of limbs (kernel vs plain) and of decoded points (all of it is
integer arithmetic)."""

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
    totals = M.msm_many(curve, [(table, p, 0) for p in plans], add, mul)
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
    table = fixed_base_device_table(curve, base, add, n_bits, sc.device)
    _build.reset_counts()
    got = fixed_base_mul_batch(curve, base, add, sc, n_bits)
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


GATHERS = {"gather_smem_rows": G.gather_smem_rows, "gather_vec": G.gather_vec,
           "gather_async": G.gather_async}


@pytest.mark.parametrize("m", [0, 1, 7, 8, 1000])
@pytest.mark.parametrize("w", [8, 16, 128])
@pytest.mark.parametrize("kind", list(GATHERS))
def test_gather_kernels_match_index_select(card, kind, w, m):
    """E1-E3 on random and sorted indices with repeats: one launch each (none
    for M = 0), equal to index_select bit for bit. A 300-row table of 512 B
    rows takes E1 above the 48 KB default of shared memory."""
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
    """E1 raises on a table above the shared-memory limit (no fallback to
    index_select), and E2, which stages nothing, gathers that table exactly
    in one launch; E2 and E3 raise on a table that is not 16-byte aligned."""
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(0, 4096, size=1000, dtype=np.int32)).to(card)
    idx[-1] = 4095
    big = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(4096, 16),
                                        dtype=np.int32)).to(card)  # 256 KiB
    _build.reset_counts()
    with pytest.raises(ValueError):
        G.gather_smem_rows(big, idx)
    flat = torch.zeros(64 * 16 + 1, dtype=torch.int32, device=card)
    for fn in (G.gather_vec, G.gather_async):
        with pytest.raises(ValueError):
            fn(flat[1:].view(64, 16), idx[:8] % 64)
    assert _build.COUNTS == {}
    got = G.gather_vec(big, idx)
    torch.cuda.synchronize()
    assert _build.COUNTS == {"gather_vec": 1}
    assert torch.equal(got, torch.index_select(big, 0, idx))


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
    to the host; the totals equal the host MSMs and the heavy sums equal
    the CPU's."""
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
    M.HOST_SYNCS.clear()
    got = M.msm_many(curve, [(table, plan, 0), (sub, plan, pad)], add, mul)
    g = curve.group
    assert _build.COUNTS[f"msm_horner_g{g}"] == 1
    assert 1 <= _build.COUNTS[f"point_fold_g{g}"] <= 2
    assert _build.COUNTS[f"heavy_rounds_g{g}"] == 1  # every segment of the group in one launch
    assert f"point_add_affine_g{g}" not in _build.COUNTS
    assert f"point_add_g{g}" not in _build.COUNTS and f"point_double_g{g}" not in _build.COUNTS
    assert M.HOST_SYNCS == {f"msm_decode_g{g}": 1}
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
@pytest.mark.parametrize("log_n", [1, 4, 10, 11, 12, 21])
def test_ntt_kernel_matches_plain(card, log_n, inverse, monkeypatch):
    """The pass kernel equals the per-stage plain version limb for limb, in
    ceil(log_n / TILE_LOG) launches; and its schedule twin in tiles of 2^3."""
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
    table = fixed_base_device_table(curve, base, add, 254, sc.device)
    _build.reset_counts()
    got = fixed_base_mul_batch(curve, base, add, sc, 254)
    assert _build.COUNTS == {f"fixed_base_g{curve.group}": 1}
    for a, b in zip(got, fixed_base_plain(curve, *table, sc, 254)):
        assert torch.equal(a, b)
    pick = [0, 1, 37, 500, 519, n - 1]
    assert curve.decode_jac(tuple(t[pick] for t in got)) == [
        mul(base, scal[i]) if scal[i] else None for i in pick]
