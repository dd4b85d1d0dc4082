"""zkpoa_tpu_torch SpMV (ops/qap_eval.py) and NTT quotient (ops/ntt.py)
against zkpoa_tpu.ops.qap_eval / ntt / ntt_blocked, with numpy-seeded
inputs; exact equality of decoded integers."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from zkpoa_tpu.fields.bn254 import R
from zkpoa_tpu.models.r1cs import PackedMatrix as JPackedMatrix
from zkpoa_tpu.models.r1cs import PackedR1CS as JPackedR1CS
from zkpoa_tpu.ops import msm_pallas as M2
from zkpoa_tpu.ops import ntt as JN
from zkpoa_tpu.ops import qap_eval as JQ
from zkpoa_tpu.ops.limbs import BN254_FR as JFR
from zkpoa_tpu.ops.ntt_blocked import quotient_blocked
from zkpoa_tpu_torch import host
from zkpoa_tpu_torch.models.pack import PackedMatrix, PackedR1CS
from zkpoa_tpu_torch.ops import ntt as N
from zkpoa_tpu_torch.ops import qap_eval as Q
from zkpoa_tpu_torch.ops.limbs import BN254_FR

torch.set_num_threads(1)


def _system(seed: int, n_cons: int, n_wires: int, hot_rows: int):
    """Random sparse (idx, wire, cid) rows for A, B, C over a small pool;
    constraint 0 and wire 0 each take `hot_rows` rows (fan-in > 2^16)."""
    rng = np.random.default_rng(seed)
    pool = [1, R - 1, 2, 7] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4)]
    mats = []
    for m in range(3):
        k = 200
        idx = rng.integers(0, n_cons, size=k)
        wire = rng.integers(0, n_wires, size=k)
        if m == 0:
            idx = np.concatenate([idx, np.zeros(hot_rows, np.int64)])
            wire = np.concatenate([wire, rng.integers(0, n_wires, size=hot_rows)])
        if m == 1:
            idx = np.concatenate([idx, rng.integers(0, n_cons, size=hot_rows)])
            wire = np.concatenate([wire, np.zeros(hot_rows, np.int64)])
        cid = rng.integers(0, len(pool), size=len(idx))
        mats.append((idx.astype(np.int32), wire.astype(np.int32), cid.astype(np.int32)))
    port = PackedR1CS(*[PackedMatrix(*m) for m in mats], pool_limbs=host.scalars_to_limbs_fast(pool),
                      n_wires=n_wires, n_public=1, n_constraints=n_cons)
    jax_p = JPackedR1CS(*[JPackedMatrix(*m) for m in mats], pool_limbs=M2.scalars_to_limbs_fast(pool),
                        n_wires=n_wires, n_public=1, n_constraints=n_cons)
    return port, jax_p, pool, mats


def _host_spmv(scatter, gather, cid, pool, vec, size):
    out = [0] * size
    for s, g, c in zip(scatter.tolist(), gather.tolist(), cid.tolist()):
        out[s] = (out[s] + pool[c] * vec[g]) % R
    return out


def test_spmv_exact_beyond_2p16_fanin():
    n_cons, n_wires, domain = 12, 10, 16
    port, jax_p, pool, mats = _system(1, n_cons, n_wires, (1 << 16) + 5)
    rng = np.random.default_rng(2)
    wit = [1] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n_wires - 1)]
    got = Q.eval_matrices_device(port, torch.from_numpy(host.scalars_to_limbs_fast(wit)), domain)
    want = JQ.eval_matrices_device(jax_p, M2.scalars_to_limbs_fast(wit), domain)
    for g, w, (idx, wire, cid) in zip(got, want, mats):
        dec = BN254_FR.from_limbs(g)
        assert dec == [int(v) for v in JFR.from_limbs(np.asarray(w))]
        assert dec == _host_spmv(idx, wire, cid, pool, wit, domain)

    # setup direction: per-wire polynomials at tau (wire 0 takes > 2^16 rows)
    lag = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(domain)]
    got_t = Q.eval_at_tau_device(port, torch.from_numpy(host.scalars_to_limbs_fast(lag)), n_wires)
    want_t = JQ.eval_at_tau_device(jax_p, jnp.asarray(M2.scalars_to_limbs_fast(lag)), n_wires)
    for g, w in zip(got_t, want_t):
        assert BN254_FR.from_limbs(g) == [int(v) for v in JFR.from_limbs(np.asarray(w))]


def test_spmv_pointwise_c_when_no_c_rows():
    port = _system(3, 8, 6, 10)[0]
    port.c = PackedMatrix(*(np.zeros(0, np.int32) for _ in range(3)))
    rng = np.random.default_rng(4)
    wit = [1] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(5)]
    a, b, c = Q.eval_matrices_device(port, torch.from_numpy(host.scalars_to_limbs_fast(wit)), 8)
    da, db = BN254_FR.from_limbs(a), BN254_FR.from_limbs(b)
    assert BN254_FR.from_limbs(c) == [x * y % R for x, y in zip(da, db)]


@pytest.mark.parametrize("log_n", [3, 5])
def test_ntt_roundtrip_and_match_jax(log_n):
    rng = np.random.default_rng(log_n)
    vals = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(1 << log_n)]
    x = BN254_FR.encode(vals, "cpu")
    jx = JFR.encode(vals)
    fwd = N.ntt(x)
    assert BN254_FR.decode(fwd) == [int(v) for v in JFR.decode(JN.ntt(jx))]
    assert BN254_FR.decode(N.ntt(fwd, inverse=True)) == vals
    w = host.domain_root(log_n)
    assert BN254_FR.decode(fwd)[1] == sum(v * pow(w, i, R) for i, v in enumerate(vals)) % R


@pytest.mark.parametrize("basis", ["monomial", "coset"])
def test_quotient_matches_jax(basis):
    n = 32
    rng = np.random.default_rng(7)
    ev = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)] for _ in range(3)]
    port_m = [BN254_FR.encode(v, "cpu") for v in ev]
    jax_m = [JFR.encode(v) for v in ev]
    if basis == "monomial":
        got = BN254_FR.decode(N.quotient(*port_m))
        want = [int(v) for v in JFR.decode(JN.quotient(*jax_m))]
    else:
        got = BN254_FR.decode(N.coset_qap_evals(*port_m))
        want = [int(v) for v in JFR.decode(JN.coset_qap_evals(*jax_m))]
    assert got == want
    blocked = quotient_blocked(*[jnp.asarray(M2.scalars_to_limbs_fast(v)) for v in ev], h_basis=basis)
    assert got == [int(v) for v in JFR.from_limbs(np.asarray(blocked))]
