"""Powers-of-tau ceremony path on the device: .ptau files, Lagrange points
by a group NTT, circuit keys from a ceremony, phase-2 contributions.

Port of `zkpoa_tpu/prover/ptau.py`, the reference's `snarkjs zkey new /
contribute / beacon` path (scripts/g16_setup.sh:240-278):

  * write_dev_ptau / read_ptau / verify_ptau: the iden3 container's
    sections 1-6 (tau^i G1 [2n - 1], tau^i G2 [n], alpha tau^i G1 [n],
    beta tau^i G1 [n], beta G2) straight to and from device tables
    (`utils/binfmt_torch.py`); the dev ceremony's points by fixed-base
    multiplication (kernel B8), as the JAX package's `_g1_batch` /
    `_g2_batch` (:144, :154);
  * lagrange_g1 / _lagrange_g2: L_i(tau) G for the circuit domain by the
    inverse group NTT of `ops/group_ntt.py` (kernels K2 and K1), G2 on the
    card too (the JAX package's host ladder, `ptau.py:325`, limited it to
    dev scale);
  * setup_from_ptau: the per-wire QAP points as sparse weighted sums of
    Lagrange points: each entry's point scaled by its coefficient (K1,
    once for every entry whose coefficient is not +-1), then summed per
    wire by the MSM's bucket kernels B5/B6 under a plan whose buckets are
    the wires; the C-side combination beta A + alpha B + C is one such sum
    over three Lagrange tables, and the monomial h-query tau^(i+m) - tau^i
    one elementwise mixed add (B2); gamma = delta = 1 (snarkjs zkey new);
  * contribute / beacon: delta' = delta d; c- and h-query scaled by 1/d
    (K1), delta1 / delta2 by d on the host.

A dev ceremony (write_dev_ptau) derives tau, alpha and beta from a seed so
the path runs offline; setup_from_ptau itself never sees tau.
"""

from __future__ import annotations

import hashlib
import struct
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import host
from ..fields import bn254
from ..fields.bn254 import R
from ..models.r1cs import R1CS
from ..ops import limbs as L
from ..ops import msm as M
from ..ops.curve import BN254_G1, DeviceG1Points, scalar_mul_batch
from ..ops.fp2 import BN254_G2, DeviceG2Points
from ..ops.group_ntt import lagrange_points
from ..ops.limbs import BN254_FQ, BN254_FR
from ..ops.ntt import pow_table
from ..utils import binfmt, binfmt_torch as BT, trace
from .groth16 import VerifyingKey
from .setup import ProvingKey, _domain, _query_device

PTAU_MAGIC = b"ptau"
N8 = 32


def _hash_to_fr(seed: str, label: str) -> int:
    h = hashlib.sha256(f"zkpoa-ptau|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def _timed(times: Optional[Dict[str, float]], key: str, device):
    """The block as span `key` (`utils/trace.py`); where `times` is given,
    also adds its seconds, the device synchronized at both ends, to
    times[key]."""
    with trace.span(key):
        if times is None:
            yield
            return
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Container I/O (snarkjs powersoftau format, sections 1-6)
# ---------------------------------------------------------------------------


def write_dev_ptau(path: str, power: int, seed: str = "zkpoa-dev-ceremony", device="cuda"):
    """A deterministic development ceremony: tau/alpha/beta from a seed,
    sections 1-6 as snarkjs `powersoftau new + contribute` lays them out
    (no transcript section 7); the bytes of `zkpoa_tpu/prover/ptau.py:56`.
    The tau powers come from `pow_table` and the points from B8, one call
    for the G1 sections and one for the G2."""
    tau = _hash_to_fr(seed, "tau")
    alpha = _hash_to_fr(seed, "alpha")
    beta = _hash_to_fr(seed, "beta")
    n = 1 << power
    spec = BN254_FR
    taus = spec.from_mont(pow_table(tau, 2 * n - 1, device))
    header = struct.pack("<I", N8) + bn254.P.to_bytes(N8, "little") + struct.pack(
        "<II", power, power)
    g1 = _query_device(BN254_G1, torch.cat([
        taus, spec.from_mont(pow_table(tau, n, device, scale=alpha)),
        spec.from_mont(pow_table(tau, n, device, scale=beta))]))
    beta_t = spec.from_mont(spec.encode([beta], device))
    g2 = _query_device(BN254_G2, torch.cat([taus[:n], beta_t]))
    sections = [
        (1, header),
        (2, BT.table_bytes(_rows(g1, slice(0, 2 * n - 1)))),
        (3, BT.table_bytes(_rows(g2, slice(0, n)))),
        (4, BT.table_bytes(_rows(g1, slice(2 * n - 1, 3 * n - 1)))),
        (5, BT.table_bytes(_rows(g1, slice(3 * n - 1, 4 * n - 1)))),
        (6, BT.table_bytes(_rows(g2, slice(n, n + 1)))),
    ]
    BT.write_container(path, PTAU_MAGIC, 1, sections)


def read_ptau(path: str, device, m: Optional[int] = None):
    """Sections 1-6 as device tables: power, tau_g1 [2n - 1], tau_g2 [n],
    alpha_tau_g1 [n], beta_tau_g1 [n] (n = 2^power), beta_g2 (a host
    point). With `m`, only the points a domain of m uses are read:
    tau_g1 [2m - 1] and m of the others."""
    secs = BT.read_sections(path, PTAU_MAGIC)
    rd = binfmt._Reader(bytes(BT.section(secs, 1)))
    n8 = rd.u32()
    if n8 != N8 or rd.fe(n8) != bn254.P:
        raise ValueError("unsupported ptau field")
    power = rd.u32()
    n = 1 << power
    if m is not None and m > n:
        raise ValueError(f"domain {m} is larger than the ceremony's 2^{power}")
    k = n if m is None else m
    return {
        "power": power,
        "tau_g1": BT.g1_table(BT.section(secs, 2), 2 * k - 1, device),
        "tau_g2": BT.g2_table(BT.section(secs, 3), k, device),
        "alpha_tau_g1": BT.g1_table(BT.section(secs, 4), k, device),
        "beta_tau_g1": BT.g1_table(BT.section(secs, 5), k, device),
        "beta_g2": binfmt._g2_parse(bytes(BT.section(secs, 6)[: 4 * N8])),
    }


def verify_ptau(pt) -> bool:
    """Spot-check ceremony consistency with real pairings on the host:
    e(tau^i G1, G2) == e(G1, tau^i G2) for a few i, and the alpha/beta
    sections against tau (as `zkpoa_tpu/prover/ptau.py:117`)."""
    from ..fields.bn254 import pairing

    g2 = bn254.G2_GEN
    rows = (1, 2, min(5, len(pt["tau_g2"]) - 1))
    tau_g1 = BT.rows_host(pt["tau_g1"], rows)
    tau_g2 = BT.rows_host(pt["tau_g2"], rows)
    for p1, p2 in zip(tau_g1, tau_g2):
        if pairing(g2, p1) != pairing(p2, bn254.G1_GEN):
            return False
    t2 = tau_g2[0]
    for name in ("alpha_tau_g1", "beta_tau_g1"):
        p0, p1 = BT.rows_host(pt[name], (0, 1))
        if pairing(g2, p1) != pairing(t2, p0):
            return False
    return True


# ---------------------------------------------------------------------------
# Group NTT: Lagrange-basis points from tau powers
# ---------------------------------------------------------------------------


def _jac(ops, tab: DeviceG1Points):
    return ops.from_affine(tab.xs, tab.ys, tab.valid)


def lagrange_g1(tab: DeviceG1Points, m: int):
    """L_i(tau) G1 for the size-m domain from the table [tau^j G1] (at
    least m rows), as Jacobian device points [m]: the inverse group NTT
    (port of `ptau.py:171`)."""
    return lagrange_points(BN254_G1, [_jac(BN254_G1, tab)], m)[0]


def _lagrange_g2(tab: DeviceG2Points, m: int):
    """G2 variant of lagrange_g1, on the device (port of `ptau.py:325`)."""
    return lagrange_points(BN254_G2, [_jac(BN254_G2, tab)], m)[0]


def _affine(ops, p) -> DeviceG1Points:
    return ops.table(*ops.to_affine(p))


def _cat(tabs: Sequence[DeviceG1Points]) -> DeviceG1Points:
    return type(tabs[0])(*(torch.cat([getattr(t, k) for t in tabs]) for k in ("xs", "ys", "valid")))


def _rows(tab: DeviceG1Points, sl: slice) -> DeviceG1Points:
    return type(tab)(tab.xs[sl], tab.ys[sl], tab.valid[sl])


def _cat_jac(parts):
    """Jacobian point arrays end to end, for one conversion to affine."""
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


# ---------------------------------------------------------------------------
# Circuit-specific key from a ceremony (snarkjs `zkey new` semantics)
# ---------------------------------------------------------------------------


def _pool_split(pool_limbs: np.ndarray):
    """Coefficient pool -> (magnitude limbs [n_pool, 8], negative, unit,
    zero): a value above (r - 1) / 2 is taken as -(r - value), so the
    common -1 is a unit like 1 and needs no ladder."""
    vals = [v % R for v in host.limbs_to_ints(pool_limbs)]
    neg = np.array([v > R // 2 for v in vals], dtype=bool)
    mags = [R - v if v > R // 2 else v for v in vals]
    return (host.scalars_to_limbs_fast(mags), neg, np.array([v == 1 for v in mags], dtype=bool),
            np.array([v == 0 for v in mags], dtype=bool))


def _scaled_entries(sums, unit: np.ndarray, zero: np.ndarray):
    """The entries of `sums` (as in `_wire_points`) that K1 scales, those of
    a coefficient other than 0 and +-1, in the order K1 takes them: by
    coefficient id (stable), so that the lanes of a warp mostly share one
    scalar. Returns their table rows and coefficient ids in that order, and
    rank[s] = the launch position of the s-th such entry in entry order."""
    rows, cids = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for entries in sums:
        for off, mat in entries:
            keep = ~zero[mat.cid] & ~unit[mat.cid]
            rows.append(off + mat.idx[keep].astype(np.int64))
            cids.append(mat.cid[keep].astype(np.int64))
    cid = np.concatenate(cids)
    order = np.argsort(cid, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return np.concatenate(rows)[order], cid[order], rank


def _wire_points(ops, table: DeviceG1Points, sums, pool_limbs: np.ndarray, n_wires: int,
                 times=None) -> List:
    """out[wire] = sum coeff * table[row] for each of `sums`, a list of
    entry lists [(row offset, PackedMatrix)], entry (i, wire, cid) adding
    pool[cid] * table[offset + i] to `wire` (port of `ptau.py:228`
    `_wire_points`, every sum at once). Entries of coefficient +-1 add the
    table row itself; every other entry's point is scaled by its
    coefficient in one K1 launch for all the sums (`_scaled_entries`),
    converted to affine, and appended to the table. Each sum is then one bucket accumulation (B5 /
    B6) whose buckets are the wires; a -1 or a negative coefficient adds
    the negated point through the plan's sign encoding. Returns Jacobian
    sums [n_wires] per entry of `sums`."""
    device = table.xs.device
    mag, neg, unit, zero = _pool_split(pool_limbs)
    s_rows, s_cids, rank = _scaled_entries(sums, unit, zero)
    n_scaled = len(s_rows)
    plans = []  # per sum: (row, negative, wire, K1 lane or -1) numpy
    n_seen = 0
    for entries in sums:
        parts = []
        for off, mat in entries:
            keep = ~zero[mat.cid]
            idx, wire, cid = (a[keep].astype(np.int64) for a in (mat.idx, mat.wire, mat.cid))
            scaled = ~unit[cid]
            slot = np.full(idx.shape[0], -1, dtype=np.int64)
            k = int(scaled.sum())
            slot[scaled] = rank[n_seen : n_seen + k]
            n_seen += k
            parts.append((off + idx, neg[cid], wire, slot))
        plans.append([np.concatenate(col) for col in zip(*parts)])
    with _timed(times, "wire points: scale", device):
        if n_scaled:
            rows = torch.from_numpy(s_rows).to(device)
            sc = torch.from_numpy(mag[s_cids]).to(device)
            pts = ops.from_affine(table.xs[rows], table.ys[rows], table.valid[rows])
            table = _cat([table, _affine(ops, scalar_mul_batch(ops, pts, sc, 254))])
    n_lag = len(table) - n_scaled
    out = []
    with _timed(times, "wire points: sum", device):
        for row, negative, wire, slot in plans:
            row = np.where(slot >= 0, n_lag + slot, row)
            plan = M.bucket_plan(torch.from_numpy(row).to(device),
                                 torch.from_numpy(negative).to(device),
                                 torch.from_numpy(wire).to(device), n_wires, len(table))
            out.append(M.accumulate(ops, table.xs, table.ys, table.valid, 0, plan))
    return out


def setup_from_ptau(r1cs: R1CS, ptau_path: str, device="cuda",
                    times: Optional[Dict[str, float]] = None) -> ProvingKey:
    """Groth16 phase-1 key from a powers-of-tau ceremony file, every table
    on `device`: the reference's `snarkjs zkey new` (g16_setup.sh:240-253;
    port of `ptau.py:255`). gamma = delta = 1 (phase-2 contributions
    update delta through contribute()). `times` receives the seconds of
    each part (read, the G1 and G2 Lagrange points, the wire points, the
    h-query, the conversions to affine) and the entry counts of A, B, C."""
    m = _domain(r1cs.n_constraints)
    with _timed(times, "read", device):
        pt = read_ptau(ptau_path, device, m)
    packed = r1cs.pack()
    if times is not None:
        times.update(nnz_a=len(packed.a.idx), nnz_b=len(packed.b.idx), nnz_c=len(packed.c.idx))
    with _timed(times, "G1 Lagrange x3", device):
        lag_jac = lagrange_points(
            BN254_G1, [_jac(BN254_G1, pt[k]) for k in ("tau_g1", "alpha_tau_g1", "beta_tau_g1")],
            m)
    with _timed(times, "affine", device):
        lag = _affine(BN254_G1, _cat_jac(lag_jac))  # [L; alpha L; beta L]
    del lag_jac
    with _timed(times, "G2 Lagrange", device):
        lag2_jac = lagrange_points(BN254_G2, [_jac(BN254_G2, pt["tau_g2"])], m)[0]
    with _timed(times, "affine", device):
        lag2 = _affine(BN254_G2, lag2_jac)
    del lag2_jac

    n_wires, n_pub = r1cs.n_wires, r1cs.n_public
    a_sum, b1_sum, comb_sum = _wire_points(
        BN254_G1, lag, [[(0, packed.a)], [(0, packed.b)],
                        # C side: beta A_k + alpha B_k + C_k, all at tau
                        [(2 * m, packed.a), (m, packed.b), (0, packed.c)]],
        packed.pool_limbs, n_wires, times)
    (b2_sum,) = _wire_points(BN254_G2, lag2, [[(0, packed.b)]], packed.pool_limbs, n_wires,
                             times)
    del lag, lag2
    # H-query (monomial): tau^i Z(tau) = tau^(i+m) - tau^i, delta = 1
    with _timed(times, "h-query", device):
        tg = pt["tau_g1"]
        hi = BN254_G1.from_affine(tg.xs[m : 2 * m - 1], tg.ys[m : 2 * m - 1],
                                  tg.valid[m : 2 * m - 1])
        h_sum = BN254_G1.add_affine(hi, tg.xs[: m - 1], L.neg_mod(BN254_FQ, tg.ys[: m - 1]),
                                    tg.valid[: m - 1])
    with _timed(times, "affine", device):
        g1 = _affine(BN254_G1, _cat_jac([a_sum, b1_sum, comb_sum, h_sum]))
        a_query, b1_query, comb = (_rows(g1, slice(k * n_wires, (k + 1) * n_wires))
                                   for k in range(3))
        h_query = _rows(g1, slice(3 * n_wires, None))
        b2_query = _affine(BN254_G2, b2_sum)
    ic = BT.rows_host(comb, range(n_pub + 1))
    alpha1 = BT.rows_host(pt["alpha_tau_g1"], [0])[0]
    beta1 = BT.rows_host(pt["beta_tau_g1"], [0])[0]
    vk = VerifyingKey(alpha_1=alpha1, beta_2=pt["beta_g2"], gamma_2=bn254.G2_GEN,
                      delta_2=bn254.G2_GEN, ic=ic, n_public=n_pub)
    return ProvingKey(
        n_vars=n_wires, n_public=n_pub, domain_size=m,
        a_query=a_query, b1_query=b1_query, c_query=_rows(comb, slice(n_pub + 1, None)),
        h_query=h_query, alpha1=alpha1, beta1=beta1, delta1=bn254.G1_GEN,
        b2_query=b2_query, beta2=pt["beta_g2"], delta2=bn254.G2_GEN,
        vk_json=vk.to_json(), h_basis="monomial",
    )


# ---------------------------------------------------------------------------
# Phase 2: contributions (snarkjs `zkey contribute` / `zkey beacon`)
# ---------------------------------------------------------------------------


def contribute(pk: ProvingKey, entropy: str) -> ProvingKey:
    """Apply one phase-2 contribution d: delta' = delta d; the c- and
    h-query are scaled by 1/d on the device, delta1 / delta2 by d on the
    host (the toxic d is discarded)."""
    d = _hash_to_fr(entropy, "delta-contribution")
    c_query, h_query = _g1_scale_list([pk.c_query, pk.h_query], pow(d, -1, R))
    delta2 = bn254.g2_mul(pk.delta2, d)
    vk = VerifyingKey.from_json(pk.vk_json)
    vk.delta_2 = delta2
    kw = dict(pk.__dict__)
    kw.update(c_query=c_query, h_query=h_query, delta1=bn254.g1_mul(pk.delta1, d),
              delta2=delta2, vk_json=vk.to_json())
    return ProvingKey(**kw)


def beacon(pk: ProvingKey, beacon_hash: str, iterations: int = 10) -> ProvingKey:
    """Final public beacon contribution (iterated hash of a public value,
    g16_setup.sh:269-278)."""
    h = beacon_hash
    for _ in range(iterations):
        h = hashlib.sha256(h.encode()).hexdigest()
    return contribute(pk, f"beacon|{h}")


def _g1_scale_list(tables: Sequence[DeviceG1Points], k: int) -> List[DeviceG1Points]:
    """[k] P for every point of the G1 tables: one K1 launch over their
    concatenation with k given once, one conversion to affine; infinity
    stays infinity."""
    tab = _cat(list(tables))
    device = tab.xs.device
    sc = torch.from_numpy(BN254_FR.to_limbs([k])).to(device)  # one scalar [1, 8]
    out = _affine(BN254_G1, scalar_mul_batch(BN254_G1, _jac(BN254_G1, tab), sc, 254))
    parts, off = [], 0
    for t in tables:
        parts.append(_rows(out, slice(off, off + len(t))))
        off += len(t)
    return parts


def setup_split(times: Dict[str, float]) -> str:
    """One line of a ceremony setup's seconds by part and its entry counts."""
    secs = ", ".join(f"{k} {v:.2f} s" for k, v in times.items() if not k.startswith("nnz"))
    nnz = ", ".join(f"{k[4:].upper()} {times[k]}" for k in ("nnz_a", "nnz_b", "nnz_c")
                    if k in times)
    return f"ceremony setup: {secs}" + (f"; nonzero entries {nnz}" if nnz else "")

