"""Back-to-back proves over the pool's witnesses: request i proves witness
i mod len(pool) under its own (r, s), through the program's entry
`prover.prove.prove(pk, r1cs, witness, device, r=, s=, log=)`."""

from __future__ import annotations

import time

from ..pool import Ctx, Request, randomness


def serve(ctx: Ctx, i: int, log=None) -> Request:
    pool = ctx.pool
    wi = i % len(pool.witnesses)
    r, s = randomness(ctx.seed, i)
    req = Request(i=i, wi=wi, r=r, s=s, t_start=time.perf_counter())
    req.proof = ctx.prove(pool.key, pool.r1cs, pool.witnesses[wi], r, s, log)
    req.t_end = time.perf_counter()
    return req
