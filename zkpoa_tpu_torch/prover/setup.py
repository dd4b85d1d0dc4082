"""Groth16 development setup over BN254 with device-resident point tables.

Port of `zkpoa_tpu/prover/setup.py`: `ProvingKey` (:41),
`_lagrange_at_tau_device` (:304), `_setup_scalars_device` (:329),
`_g1_query_device` / `_g2_query_device` (:171, :204) as one
`_query_device` of the curve, `_g1_points_from_scalars` /
`_g2_points_from_scalars` as one `_points_from_scalars`, `setup_device`
(:541), and the host-list `setup` (:485), built as `setup_device` then
`host_lists`. The device point tables (:100, :132) live beside their
curves, in `ops/curve.py` and `ops/fp2.py`. The trapdoors come from the
same seeded hash, so for the same circuit and seed the port makes the
same key as the JAX package.

SECURITY NOTE: a development setup; the toxic waste is derived from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from .. import host
from ..fields.bn254 import R
from ..models.r1cs import R1CS
from ..ops import limbs as L
from ..ops.curve import BN254_G1, DeviceG1Points, fixed_base_mul_batch
from ..ops.fp2 import BN254_G2, DeviceG2Points
from ..ops.limbs import BN254_FR
from ..ops.ntt import pow_table
from ..ops.qap_eval import eval_at_tau_device
from .groth16 import VerifyingKey

SETUP_CHUNK = 1 << 20  # fixed-base scalars per batch (bounds scratch memory)


@dataclass
class ProvingKey:
    n_vars: int
    n_public: int
    domain_size: int
    a_query: DeviceG1Points
    b1_query: DeviceG1Points
    c_query: DeviceG1Points  # private wires k - (n_public + 1)
    h_query: DeviceG1Points
    alpha1: Tuple[int, int]
    beta1: Tuple[int, int]
    delta1: Tuple[int, int]
    b2_query: DeviceG2Points
    beta2: Tuple
    delta2: Tuple
    vk_json: Dict
    # 'monomial': H_i = (tau^i Z(tau)/delta) G1, domain_size - 1 points;
    # 'coset': snarkjs' coset-Lagrange basis, domain_size points
    h_basis: str = "monomial"

    def to(self, device) -> "ProvingKey":
        kw = dict(self.__dict__)
        for name in ("a_query", "b1_query", "c_query", "h_query", "b2_query"):
            kw[name] = getattr(self, name).to(device)
        return ProvingKey(**kw)


def _domain(n_constraints: int) -> int:
    m = 1
    while m < max(n_constraints, 2):
        m <<= 1
    return m


def _lagrange_at_tau_device(m: int, tau: int, device, shift_div: int = 1):
    """L_i(t') for t' = tau / shift_div as Montgomery limbs [m, 8]:
    lag_i = z * w^i / (m (t' - w^i)), z = t'^m - 1. Returns (lag, z)."""
    spec = BN254_FR
    w = host.domain_root(m.bit_length() - 1)
    tp = tau * pow(shift_div, -1, R) % R
    z_at = (pow(tp, m, R) - 1) % R
    if z_at == 0:
        raise ValueError("tau hit the domain; pick another seed")
    roots = pow_table(w, m, device)
    tp_m = spec.encode([tp], device)
    dinv = L.mont_inv(spec, L.sub_mod(spec, tp_m.expand(m, 8), roots))
    lag = L.mont_mul(spec, roots, dinv)
    lag = L.mont_mul(spec, lag, spec.encode([z_at * pow(m, -1, R) % R], device))
    return lag, z_at


def _setup_scalars_device(r1cs: R1CS, seed: str, h_basis: str, device):
    """QAP at tau and every query's scalars on the device, as plain limbs
    (ic_scalars as host ints: O(n_public))."""
    spec = BN254_FR
    tau, alpha, beta, gamma, delta = (
        host._hash_to_fr(seed, k) for k in ("tau", "alpha", "beta", "gamma", "delta")
    )
    m = _domain(r1cs.n_constraints)
    lag_m, z_tau = _lagrange_at_tau_device(m, tau, device)
    a_t, b_t, c_t = eval_at_tau_device(r1cs.pack(), spec.from_mont(lag_m), r1cs.n_wires)

    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)
    n_pub = r1cs.n_public
    enc = lambda x: spec.encode([x % R], device)  # noqa: E731
    t_all = L.add_mod(
        spec,
        L.add_mod(spec, L.mont_mul(spec, a_t, enc(beta)), L.mont_mul(spec, b_t, enc(alpha))),
        c_t,
    )
    ic_scalars = [x * gamma_inv % R for x in spec.from_limbs(t_all[: n_pub + 1])]
    c_scalars = L.mont_mul(spec, t_all[n_pub + 1:], enc(delta_inv))

    if h_basis == "monomial":
        h_scalars = spec.from_mont(pow_table(tau, m - 1, device, scale=z_tau * delta_inv % R))
    elif h_basis == "coset":
        g = host.snarkjs_coset_shift(m.bit_length() - 1)
        zc_inv = pow((pow(g, m, R) - 1) % R, -1, R)
        lag_c, _ = _lagrange_at_tau_device(m, tau, device, shift_div=g)
        h_scalars = spec.from_mont(L.mont_mul(spec, lag_c, enc(z_tau * zc_inv % R * delta_inv)))
    else:
        raise ValueError(f"unknown h_basis {h_basis!r}")
    return dict(m=m, n_pub=n_pub, n_vars=r1cs.n_wires, a_t=a_t, b_t=b_t,
                c_scalars=c_scalars, h_scalars=h_scalars, ic_scalars=ic_scalars,
                alpha=alpha, beta=beta, gamma=gamma, delta=delta)


def _query_device(curve, scalars: torch.Tensor):
    """[k_i G] for the curve's generator G as the curve's affine device
    table, in SETUP_CHUNK batches of fixed-base multiplication plus one
    batched inversion each."""
    parts = []
    for off in range(0, scalars.shape[0], SETUP_CHUNK):
        jac = fixed_base_mul_batch(curve, curve.generator, scalars[off : off + SETUP_CHUNK], 254)
        parts.append(curve.to_affine(jac))
    if not parts:
        empty = curve.infinity((0,), scalars.device)
        return curve.table(empty[0], empty[1],
                           torch.zeros(0, dtype=torch.bool, device=scalars.device))
    return curve.table(*(torch.cat([p[i] for p in parts]) for i in range(3)))


def _points_from_scalars(curve, scalars: Sequence[int], device) -> List:
    """[k_i G] for the curve's generator G as host affine points (few
    points)."""
    sc = torch.from_numpy(host.witness_limbs(scalars)[0]).to(device)
    return curve.decode_jac(fixed_base_mul_batch(curve, curve.generator, sc, 254))


def setup_device(r1cs: R1CS, device, seed: str = "zkpoa-test-srs",
                 h_basis: str = "monomial", log=None) -> ProvingKey:
    """Development Groth16 setup with every query table on `device`."""
    log = log or (lambda msg: None)
    s = _setup_scalars_device(r1cs, seed, h_basis, device)
    log("setup: QAP scalars ready")
    g1_scalars = [s["a_t"], s["b_t"], s["c_scalars"], s["h_scalars"]]
    g1 = _query_device(BN254_G1, torch.cat(g1_scalars))  # one batch for the four
    tables, off = [], 0
    for part in g1_scalars:
        sl = slice(off, off + part.shape[0])
        tables.append(DeviceG1Points(g1.xs[sl], g1.ys[sl], g1.valid[sl]))
        off += part.shape[0]
    a_query, b1_query, c_query, h_query = tables
    log("setup: G1 queries ready")
    b2_query = _query_device(BN254_G2, s["b_t"])
    log("setup: G2 query ready")

    alpha, beta, gamma, delta = s["alpha"], s["beta"], s["gamma"], s["delta"]
    small = _points_from_scalars(BN254_G1, s["ic_scalars"] + [alpha, beta, delta], device)
    ic_pts = small[: len(s["ic_scalars"])]
    alpha1, beta1, delta1 = small[-3], small[-2], small[-1]
    beta2, gamma2, delta2 = _points_from_scalars(BN254_G2, [beta, gamma, delta], device)
    vk = VerifyingKey(alpha_1=alpha1, beta_2=beta2, gamma_2=gamma2, delta_2=delta2,
                      ic=ic_pts, n_public=s["n_pub"])
    return ProvingKey(
        n_vars=s["n_vars"], n_public=s["n_pub"], domain_size=s["m"],
        a_query=a_query, b1_query=b1_query, c_query=c_query, h_query=h_query,
        alpha1=alpha1, beta1=beta1, delta1=delta1,
        b2_query=b2_query, beta2=beta2, delta2=delta2,
        vk_json=vk.to_json(), h_basis=h_basis,
    )


def table_points(tab: DeviceG1Points) -> List:
    """A G1 or G2 table as host affine points (None where not valid): one
    copy of the coordinates to the host, decoded from Montgomery form."""
    n = len(tab)
    if n == 0:
        return []
    k = tab.xs[0].numel() // 8  # limbs rows a coordinate: 1 (Fq) or 2 (Fq2)
    vals = L.BN254_FQ.decode(
        torch.cat([tab.xs.reshape(n, k, 8), tab.ys.reshape(n, k, 8)], 1).reshape(-1, 8))
    valid = tab.valid.tolist()
    out = []
    for i, ok in enumerate(valid):
        v = vals[2 * k * i : 2 * k * (i + 1)]
        if not ok:
            out.append(None)
        elif k == 1:
            out.append((v[0], v[1]))
        else:
            out.append(((v[0], v[1]), (v[2], v[3])))
    return out


def host_lists(pk: ProvingKey) -> ProvingKey:
    """The key with every query table decoded to a host list of affine
    points (the JAX package's host-list `ProvingKey`: what the copied
    `utils/binfmt.write_zkey` and the tests take)."""
    kw = dict(pk.__dict__)
    for name in ("a_query", "b1_query", "c_query", "h_query", "b2_query"):
        kw[name] = table_points(getattr(pk, name))
    return ProvingKey(**kw)


def setup(r1cs: R1CS, seed: str = "zkpoa-test-srs", h_basis: str = "monomial",
          device="cuda") -> ProvingKey:
    """Development Groth16 setup with host-list tables (port of
    `zkpoa_tpu/prover/setup.py:485` `setup`): `setup_device` on `device`,
    then `host_lists`."""
    return host_lists(setup_device(r1cs, device, seed=seed, h_basis=h_basis))
