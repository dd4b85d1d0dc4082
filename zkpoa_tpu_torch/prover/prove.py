"""Groth16 proving against a device-resident key: witness -> proof.

Port of `zkpoa_tpu/prover/prove.py` (`_prove_device` :91, `_assemble_proof`
:227, `prove` :239). One path on every device, the JAX package's shared-
plan branch: witness upload, SpMV for the QAP evaluations, the quotient
h(X) by NTTs, ONE witness MSM plan shared by the a/b1/b2/c queries (the
c-query rides it with prefix_pad = n_public + 1), the h-query MSM on its
own plan (the four G1 MSMs share one Horner pass), then assembly on the
host. The randomness (r, s) comes from the
same seeded hash as the JAX package, so the proofs are identical.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from .. import host
from ..fields import bn254
from ..fields.bn254 import R
from ..models.r1cs import R1CS
from ..ops import msm as M
from ..ops.curve import BN254_G1
from ..ops.fp2 import BN254_G2
from ..ops.limbs import BN254_FR
from ..ops.ntt import coset_qap_evals, quotient
from ..ops.qap_eval import eval_matrices_device
from .groth16 import Proof
from .setup import ProvingKey


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _prove_device(pk: ProvingKey, r1cs: R1CS, witness: Sequence[int], r: int, s: int,
                  device, log: Callable[[str], None]) -> Proof:
    spec = BN254_FR
    t0 = time.perf_counter()

    def phase(name):
        _sync(device)
        log(f"prove: {name} {time.perf_counter() - t0:.3f}s")

    w_dev = torch.from_numpy(host.scalars_to_limbs_fast([int(x) % R for x in witness])).to(device)
    phase("witness upload")
    a_p, b_p, c_p = eval_matrices_device(r1cs.pack(), w_dev, pk.domain_size)
    phase("QAP SpMV")
    a_m, b_m, c_m = (spec.to_mont(v) for v in (a_p, b_p, c_p))
    if pk.h_basis == "monomial":
        h = spec.from_mont(quotient(a_m, b_m, c_m))[: len(pk.h_query)]
    elif pk.h_basis == "coset":
        h = spec.from_mont(coset_qap_evals(a_m, b_m, c_m))
    else:
        raise ValueError(f"unknown h_basis {pk.h_basis!r}")
    del a_p, b_p, c_p, a_m, b_m, c_m
    phase("quotient h(X)")

    wplan = M.plan_msm(w_dev)
    hplan = M.plan_msm(h, M.auto_c(len(pk.h_query)), split_heavy=False)
    phase(f"MSM plans (c={wplan.c}/{hplan.c}, {len(wplan.heavy)} heavy values)")
    a_acc, b1_acc, c_acc, h_acc = M.msm_many(BN254_G1, [
        (pk.a_query, wplan, 0), (pk.b1_query, wplan, 0),
        (pk.c_query, wplan, pk.n_public + 1), (pk.h_query, hplan, 0),
    ], bn254.g1_add, bn254.g1_mul)
    phase("a/b1/c/h G1 MSMs")
    b2_acc = M.msm_shared(BN254_G2, pk.b2_query, wplan, bn254.g2_add, bn254.g2_mul)
    phase("b2 G2 MSM")
    proof = _assemble_proof(pk, a_acc, b1_acc, c_acc, h_acc, b2_acc, r, s)
    phase("assembly")
    return proof


def _assemble_proof(pk, a_acc, b1_acc, c_acc, h_acc, b2_acc, r, s) -> Proof:
    g1 = bn254
    pi_a = g1.g1_add(g1.g1_add(pk.alpha1, a_acc), g1.g1_mul(pk.delta1, r))
    pi_b1 = g1.g1_add(g1.g1_add(pk.beta1, b1_acc), g1.g1_mul(pk.delta1, s))
    pi_b2 = bn254.g2_add(bn254.g2_add(pk.beta2, b2_acc), bn254.g2_mul(pk.delta2, s))
    pi_c = g1.g1_add(c_acc, h_acc)
    pi_c = g1.g1_add(pi_c, g1.g1_mul(pi_a, s))
    pi_c = g1.g1_add(pi_c, g1.g1_mul(pi_b1, r))
    pi_c = g1.g1_add(pi_c, g1.g1_neg(g1.g1_mul(pk.delta1, r * s % R)))
    return Proof(pi_a=pi_a, pi_b=pi_b2, pi_c=pi_c)


def prove(pk: ProvingKey, r1cs: R1CS, witness: Sequence[int], device,
          seed: str = "zkpoa-proof", r: Optional[int] = None, s: Optional[int] = None,
          log: Optional[Callable[[str], None]] = None) -> Proof:
    """Groth16 proof of `witness` under `pk`, computed on `device` (the
    key's tables move there if they lie elsewhere)."""
    assert len(witness) == pk.n_vars
    r = host._rand_fr(seed, "r") if r is None else r % R
    s = host._rand_fr(seed, "s") if s is None else s % R
    if pk.a_query.xs.device != torch.device(device):
        pk = pk.to(device)
    return _prove_device(pk, r1cs, witness, r, s, device, log or (lambda msg: None))
