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
from typing import Callable, List, Optional, Sequence, Tuple

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
from ..utils import trace
from .groth16 import Proof
from .setup import ProvingKey


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stack(rows):
    """[B, ...] of B same-shape tensors; a batch of one is a view, no copy."""
    return rows[0].unsqueeze(0) if len(rows) == 1 else torch.stack(rows)


def _upload(witness: Sequence[int], device) -> torch.Tensor:
    """A witness as plain limbs [n, 8] on the device."""
    with trace.span("prove.upload.limbs"):
        limbs, n_miss = host.witness_limbs(witness)
        if n_miss:
            trace.count("convert_fallback", n_miss, site="witness")
    with trace.span("prove.upload.copy"):
        trace.count("h2d_bytes", limbs.nbytes, site="witness")
        trace.count("host_sync", site="witness")  # a pageable copy waits on the stream
        return torch.from_numpy(limbs).to(device)


def _prove_device(pk: ProvingKey, r1cs: R1CS, witnesses: Sequence[Sequence[int]],
                  rs: Sequence[Tuple[int, int]], device,
                  log: Optional[Callable[[str], None]]) -> List[Proof]:
    """Proofs of same-shape witnesses, with randomness rs[i] = (r, s): the
    QAP evaluations of all of them stacked through one quotient (the NTT
    pass kernel takes the leading axis as a batch), then every witness's
    a/b1/c/h MSMs in one `msm_many` and the b2 MSMs in another. A batch of
    one is the single prove; a batch of several gives each witness the
    group elements, so the proof, that its own prove gives. Each phase is
    a span (`utils/trace.py`); a caller's `log` gets each phase's end
    after a device synchronize, and without one nothing synchronizes."""
    spec = BN254_FR
    t0 = time.perf_counter()

    def phase(name):
        if log is not None:
            _sync(device)
            trace.count("host_sync", site="prove.phase")
            log(f"prove: {name} {time.perf_counter() - t0:.3f}s")

    with trace.span("prove", root=True):
        with trace.span("prove.upload"):
            w_devs = [_upload(w, device) for w in witnesses]
        phase("witness upload")
        with trace.span("prove.spmv"):
            packed = r1cs.pack()
            evals = [eval_matrices_device(packed, w_dev, pk.domain_size) for w_dev in w_devs]
        phase("QAP SpMV")
        with trace.span("prove.quotient"):
            a_m, b_m, c_m = (spec.to_mont(_stack([e[k] for e in evals])) for k in range(3))
            del evals
            if pk.h_basis == "monomial":
                h = spec.from_mont(quotient(a_m, b_m, c_m))[:, : len(pk.h_query)]
            elif pk.h_basis == "coset":
                h = spec.from_mont(coset_qap_evals(a_m, b_m, c_m))
            else:
                raise ValueError(f"unknown h_basis {pk.h_basis!r}")
            del a_m, b_m, c_m
        phase("quotient h(X)")
        with trace.span("prove.plans"):
            wplans = [M.plan_msm(w_dev) for w_dev in w_devs]
            hplans = [M.plan_msm(h[i], split_heavy=False) for i in range(len(witnesses))]
            del h
            heavy = sum(len(p.heavy) for p in wplans)
        phase(f"MSM plans (c={wplans[0].c}/{hplans[0].c}, {heavy} heavy values)")
        with trace.span("prove.g1_msms"):
            jobs = []
            for wplan, hplan in zip(wplans, hplans):
                jobs += [(pk.a_query, wplan, 0), (pk.b1_query, wplan, 0),
                         (pk.c_query, wplan, pk.n_public + 1), (pk.h_query, hplan, 0)]
            g1 = M.msm_many(BN254_G1, jobs)
        phase("a/b1/c/h G1 MSMs")
        with trace.span("prove.g2_msm"):
            b2 = M.msm_many(BN254_G2, [(pk.b2_query, wplan, 0) for wplan in wplans])
        phase("b2 G2 MSM")
        with trace.span("prove.assembly"):
            proofs = [_assemble_proof(pk, *g1[4 * i: 4 * i + 4], b2[i], r, s)
                      for i, (r, s) in enumerate(rs)]
        phase("assembly")
    return proofs


def _assemble_proof(pk, a_acc, b1_acc, c_acc, h_acc, b2_acc, r, s) -> Proof:
    trace.count("host_mul", 5, site="assembly_g1")  # delta1 r, delta1 s, pi_a s, pi_b1 r, delta1 rs
    trace.count("host_mul", site="assembly_g2")  # delta2 s
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
    return _prove_device(pk, r1cs, [witness], [(r, s)], device, log)[0]
