"""The port's iden3 container I/O: `utils/binfmt.py` (the copy of the JAX
package's per-point codecs) and `utils/binfmt_torch.py` (whole sections to
and from device tables).

* .r1cs, .wtns and .zkey round trips through the port;
* `write_zkey_device` writes the bytes of the copied `write_zkey` on the
  decoded key (`host_lists`), in the monomial and the coset h basis;
* the bulk codec equals the per-point `_g1_bytes` / `_g2_bytes` /
  `_g1_parse` / `_g2_parse`, infinity included;
* `read_zkey_device` of a .zkey written by `zkpoa_tpu` equals
  `proving_key_from_jax(read_zkey(...))`, and the host-list `setup` gives
  the key `zkpoa_tpu`'s `setup` wrote there;
* the snarkjs-layout container of `tests/test_zkey_golden.py`, assembled
  here from the documented layout, proves and verifies through the port on
  the CPU, read as 'auto' (and as 'coset', the same key).

Tolerance: exact (bytes, limbs, decoded points)."""

import random
import struct

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu_torch.convert import proving_key_from_jax
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.fields.bn254 import P, R
from zkpoa_tpu_torch.host import domain_root, snarkjs_coset_shift
from zkpoa_tpu_torch.models.r1cs import Circuit
from zkpoa_tpu_torch.ops.curve import BN254_G1, DeviceG1Points
from zkpoa_tpu_torch.ops.fp2 import BN254_G2, DeviceG2Points
from zkpoa_tpu_torch.prover import groth16
from zkpoa_tpu_torch.prover.prove import prove
from zkpoa_tpu_torch.prover.setup import host_lists, setup, setup_device
from zkpoa_tpu_torch.utils import binfmt
from zkpoa_tpu_torch.utils import binfmt_torch as BT

torch.set_num_threads(1)

TABLES = ("a_query", "b1_query", "c_query", "h_query", "b2_query")
HOST = ("n_vars", "n_public", "domain_size", "alpha1", "beta1", "delta1", "beta2", "delta2",
        "vk_json", "h_basis")


def _toy(frontend=Circuit):
    c = frontend()
    out = c.public_output()
    x, y = c.var(5), c.var(9)
    c.bind_output(out, c.mul(x, y) * 3 + x - 7)
    return c.compile()


@pytest.fixture(scope="module", params=["monomial", "coset"])
def key(request):
    r1cs, wit = _toy()
    return r1cs, wit, setup_device(r1cs, "cpu", seed="binfmt", h_basis=request.param)


def _same_key(a, b):
    for name in TABLES:
        ta, tb = getattr(a, name), getattr(b, name)
        assert torch.equal(ta.valid, tb.valid), name
        for k in ("xs", "ys"):
            assert torch.equal(getattr(ta, k)[ta.valid], getattr(tb, k)[tb.valid]), name
    for name in HOST:
        assert getattr(a, name) == getattr(b, name), name


def test_r1cs_and_wtns_round_trip(tmp_path):
    r1cs, wit = _toy()
    binfmt.write_r1cs(str(tmp_path / "t.r1cs"), r1cs)
    back = binfmt.read_r1cs(str(tmp_path / "t.r1cs"))
    assert (back.n_wires, back.n_public, back.n_constraints) == (
        r1cs.n_wires, r1cs.n_public, r1cs.n_constraints)
    for rows in ("a_rows", "b_rows", "c_rows"):
        assert getattr(back, rows) == list(getattr(r1cs, rows))
    binfmt.write_wtns(str(tmp_path / "t.wtns"), wit)
    assert binfmt.read_wtns(str(tmp_path / "t.wtns")) == wit


def test_zkey_device_bytes_equal_the_copied_writer_and_round_trip(key, tmp_path):
    r1cs, wit, pk = key
    dev, ref = str(tmp_path / "dev.zkey"), str(tmp_path / "ref.zkey")
    BT.write_zkey_device(dev, pk, r1cs)
    binfmt.write_zkey(ref, host_lists(pk), r1cs)
    with open(dev, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    back, rows = BT.read_zkey_device(dev, "cpu", h_basis=pk.h_basis)
    _same_key(back, pk)
    ref_pk, coeffs = binfmt.read_zkey(ref, h_basis="auto")
    assert ref_pk.h_basis == pk.h_basis
    assert BT.read_zkey_device(dev, "cpu", h_basis="auto")[0].h_basis == pk.h_basis
    want = binfmt.r1cs_from_zkey_coeffs(coeffs, pk.n_vars, pk.n_public)
    assert list(rows.a_rows) == want.a_rows and list(rows.b_rows) == want.b_rows
    assert list(rows.c_rows) == [] and rows.n_constraints == want.n_constraints
    assert host_lists(back).a_query == ref_pk.a_query
    if pk.h_basis == "monomial":  # its infinity tail is not a coset basis
        with pytest.raises(ValueError, match="coset"):
            BT.read_zkey_device(dev, "cpu", h_basis="coset")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bulk_codec_equals_the_per_point_codec(group):
    rng = random.Random(7)
    if group == "g1":
        ops, mul, gen, enc, parse, width = (BN254_G1, bn254.g1_mul, bn254.G1_GEN,
                                            binfmt._g1_bytes, binfmt._g1_parse, 64)
        table, cls = BT.g1_table, DeviceG1Points
    else:
        ops, mul, gen, enc, parse, width = (BN254_G2, bn254.g2_mul, bn254.G2_GEN,
                                            binfmt._g2_bytes, binfmt._g2_parse, 128)
        table, cls = BT.g2_table, DeviceG2Points
    pts = [mul(gen, rng.randrange(1, R)) for _ in range(5)]
    pts[2] = None
    raw = b"".join(enc(p) for p in pts)
    tab = table(np.frombuffer(raw, np.uint8), len(pts), "cpu")
    assert tab.valid.tolist() == [p is not None for p in pts]
    assert BT.table_bytes(tab).tobytes() == raw
    assert BT.rows_host(tab, range(len(pts))) == [parse(raw[i * width : (i + 1) * width])
                                                   for i in range(len(pts))]
    # an invalid row is written as zeros whatever its coordinates hold
    xs, ys, valid = ops.encode_affine(pts[:2], "cpu")
    junk = cls(xs, ys, torch.tensor([True, False]))
    assert BT.table_bytes(junk).tobytes() == enc(pts[0]) + enc(None)


@pytest.fixture(scope="module")
def jax_key():
    from zkpoa_tpu.models.r1cs import Circuit as JaxCircuit
    from zkpoa_tpu.prover.setup import setup as jax_setup

    r1cs, _ = _toy(JaxCircuit)
    return r1cs, jax_setup(r1cs, seed="jax-written")


def test_host_list_setup_equals_jax_setup(jax_key):
    """`prover/setup.py` `setup` (setup_device, then host_lists) gives the
    JAX package's host-list key."""
    _r1cs, jpk = jax_key
    r1cs, _ = _toy()
    pk = setup(r1cs, seed="jax-written", device="cpu")
    for name in TABLES:
        assert getattr(pk, name) == list(getattr(jpk, name)), name
    for name in HOST:
        assert getattr(pk, name) == getattr(jpk, name), name


def test_read_zkey_device_of_a_jax_written_zkey(jax_key, tmp_path):
    from zkpoa_tpu.utils import binfmt as jax_binfmt

    r1cs, jpk = jax_key
    path = str(tmp_path / "jax.zkey")
    jax_binfmt.write_zkey(path, jpk, r1cs)
    want = proving_key_from_jax(jax_binfmt.read_zkey(path)[0], "cpu")
    got, rows = BT.read_zkey_device(path, "cpu")
    _same_key(got, want)
    coeffs = jax_binfmt.read_zkey(path)[1]
    assert list(rows.a_rows) == [(c, s, v) for m, c, s, v in coeffs if m == 0]
    assert list(rows.b_rows) == [(c, s, v) for m, c, s, v in coeffs if m == 1]


def _golden_zkey(path):
    """The container of tests/test_zkey_golden.py, assembled from the
    documented snarkjs layout: out = x * y, coset-Lagrange section 9."""
    n_vars, n_pub, n_cons, m = 4, 1, 1, 4
    a_rows = [(0, 2, 1)] + [(n_cons + s, s, 1) for s in range(n_pub + 1)]
    b_rows = [(0, 3, 1)]
    c_rows = [(0, 1, 1)]
    tau, alpha, beta, gamma, delta = 123457, 777, 888, 999, 1111
    w = domain_root(2)

    def lag_at(x, i):
        wi = pow(w, i, R)
        return wi * (pow(x, m, R) - 1) % R * pow(m * (x - wi) % R, -1, R) % R

    def at_tau(rows, k):
        return sum(v * lag_at(tau, c) for c, s, v in rows if s == k) % R

    A, B, C = ([at_tau(rows, k) for k in range(n_vars)] for rows in (a_rows, b_rows, c_rows))
    g1m, g2m, G1, G2 = bn254.g1_mul, bn254.g2_mul, bn254.G1_GEN, bn254.G2_GEN
    comb = [(beta * A[k] + alpha * B[k] + C[k]) % R for k in range(n_vars)]
    ic = [g1m(G1, comb[k] * pow(gamma, -1, R) % R) for k in range(n_pub + 1)]
    c_q = [g1m(G1, comb[k] * pow(delta, -1, R) % R) for k in range(n_pub + 1, n_vars)]
    g = snarkjs_coset_shift(2)
    scale = (pow(tau, m, R) - 1) * pow((pow(g, m, R) - 1) * delta % R, -1, R) % R
    h_q = [g1m(G1, lag_at(tau * pow(g, -1, R) % R, i) * scale % R) for i in range(m)]

    def mont(x):
        return (x % P * ((1 << 256) % P) % P).to_bytes(32, "little")

    def g1(pt):
        return b"\0" * 64 if pt is None else mont(pt[0]) + mont(pt[1])

    def g2(pt):
        if pt is None:
            return b"\0" * 128
        return mont(pt[0][0]) + mont(pt[0][1]) + mont(pt[1][0]) + mont(pt[1][1])

    sec2 = (struct.pack("<I", 32) + P.to_bytes(32, "little") + struct.pack("<I", 32)
            + R.to_bytes(32, "little") + struct.pack("<III", n_vars, n_pub, m)
            + g1(g1m(G1, alpha)) + g1(g1m(G1, beta)) + g2(g2m(G2, beta)) + g2(g2m(G2, gamma))
            + g1(g1m(G1, delta)) + g2(g2m(G2, delta)))
    recs = [(0, c, s, v) for c, s, v in a_rows] + [(1, c, s, v) for c, s, v in b_rows]
    sec4 = struct.pack("<I", len(recs)) + b"".join(
        struct.pack("<III", mm, c, s) + (v * ((1 << 256) % R) % R).to_bytes(32, "little")
        for mm, c, s, v in recs)
    sections = [(1, struct.pack("<I", 1)), (2, sec2), (3, b"".join(g1(p) for p in ic)),
                (4, sec4), (5, b"".join(g1(g1m(G1, A[k])) for k in range(n_vars))),
                (6, b"".join(g1(g1m(G1, B[k])) for k in range(n_vars))),
                (7, b"".join(g2(g2m(G2, B[k])) for k in range(n_vars))),
                (8, b"".join(g1(p) for p in c_q)), (9, b"".join(g1(p) for p in h_q))]
    with open(path, "wb") as f:
        f.write(b"zkey" + struct.pack("<II", 1, len(sections)))
        for stype, payload in sections:
            f.write(struct.pack("<IQ", stype, len(payload)) + payload)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "golden.zkey")
    _golden_zkey(path)
    return path


def test_golden_snarkjs_zkey_proves_through_the_port(golden):
    pk, r1cs = BT.read_zkey_device(golden, "cpu", h_basis="auto")
    assert pk.h_basis == "coset" and pk.domain_size == 4 and pk.n_vars == 4
    coset, rows = BT.read_zkey_device(golden, "cpu", h_basis="coset")
    _same_key(coset, pk)  # read as 'coset', the same key: the same proof
    assert list(rows.a_rows) == list(r1cs.a_rows) and list(rows.b_rows) == list(r1cs.b_rows)
    x, y = 6, 7
    proof = prove(pk, r1cs, [1, x * y, x, y], "cpu", seed="golden")
    vk = groth16.VerifyingKey.from_json(pk.vk_json)
    assert groth16.verify(vk, proof, [x * y])
    assert not groth16.verify(vk, proof, [x * y + 1])
