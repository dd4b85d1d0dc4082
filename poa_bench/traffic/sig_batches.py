"""Signatures arriving as batches: request i makes a fresh batch of the
configuration's size from the run's seed, builds its circuit and witness
through the circuit kind's `build_one`, and proves it under the pool's
key. The host build is the request's first phase ("witness build"), so
the traced run shows it beside the prover's phases."""

from __future__ import annotations

import time

from ..pool import Ctx, Request, randomness, same_structure


def serve(ctx: Ctx, i: int, log=None) -> Request:
    pool = ctx.pool
    r, s = randomness(ctx.seed, i)
    req = Request(i=i, wi=-1, r=r, s=s, t_start=time.perf_counter())
    r1cs, witness, raw = ctx.circuit.build_one(ctx.config, f"{ctx.seed}|req{i}")
    if not same_structure(r1cs, pool.r1cs):
        raise RuntimeError(f"request {i} built another constraint system than the key's")
    pool.witnesses.append(witness)
    pool.raws.append(raw)
    req.wi = len(pool.witnesses) - 1
    if log is not None:
        log("poa_bench: witness build")
    req.proof = ctx.prove(pool.key, pool.r1cs, witness, r, s, log)
    req.t_end = time.perf_counter()
    return req
