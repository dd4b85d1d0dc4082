"""What a cell's set-up hands to its traffic: the constraint system, the
witnesses, the key, and the seeds the reference needs again."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from .reference.bn254 import R
from .reference.groth16 import Statement


def statement_of(r1cs) -> Statement:
    """The program's constraint system as the reference's plain arrays.
    The frontend keeps each matrix as packed rows (constraint, wire and
    coefficient-id arrays) over one coefficient pool of Python ints."""
    mats, pool = {}, None
    for name in ("a", "b", "c"):
        rows = getattr(r1cs, f"{name}_rows")
        if pool is not None and rows.pool is not pool:
            raise ValueError("the three matrices do not share one coefficient pool")
        pool = rows.pool
        mats[name] = tuple(np.frombuffer(a, dtype=np.int64).copy()
                           for a in (rows.idx, rows.wire, rows.cid))
    return Statement(entries=mats, pool=list(pool), n_constraints=r1cs.n_constraints,
                     n_wires=r1cs.n_wires, n_public=r1cs.n_public)


def same_structure(a, b) -> bool:
    """Whether two constraint systems are one (a key of one proves the
    witnesses of the other)."""
    sa, sb = statement_of(a), statement_of(b)
    if (sa.n_constraints, sa.n_wires, sa.n_public, sa.pool) != \
            (sb.n_constraints, sb.n_wires, sb.n_public, sb.pool):
        return False
    return all(np.array_equal(x, y) for name in ("a", "b", "c")
               for x, y in zip(sa.entries[name], sb.entries[name]))


@dataclass
class Pool:
    kind: str  # the circuit kind: modules circuits/<kind>.py and reference/<kind>.py
    r1cs: object
    witnesses: List[List[int]]
    raws: List[dict]  # per witness, the seeds its public values follow from
    key: object
    key_seed: str
    _statement: Optional[Statement] = field(default=None, repr=False)

    def statement(self) -> Statement:
        if self._statement is None:
            self._statement = statement_of(self.r1cs)
        return self._statement


@dataclass
class Request:
    i: int
    wi: int  # index into the pool's witnesses
    r: int
    s: int
    t_start: float
    t_end: float = 0.0
    proof: Optional[tuple] = None  # (pi_a, pi_b, pi_c) as host points
    error: Optional[str] = None
    phases: List[Tuple[str, float]] = field(default_factory=list)  # (name, host clock at its end)


@dataclass
class Ctx:
    config: dict
    seed: int
    pool: Pool
    circuit: object  # the circuits/<kind>.py module
    prove: Callable  # (key, r1cs, witness, r, s, log) -> (pi_a, pi_b, pi_c)
    memo: dict = field(default_factory=dict)  # what readers work out once a run


def randomness(seed: int, i: int) -> Tuple[int, int]:
    """The (r, s) of request i: a hash of the run's seed and the index."""
    def h(label):
        d = hashlib.sha256(f"poa_bench|{seed}|{i}|{label}".encode()).digest()
        return int.from_bytes(d + hashlib.sha256(d).digest(), "big") % R
    return h("r"), h("s")


@dataclass
class RunData:
    """What the metric readers read: the measured requests (the window's, or
    the traced block's), set-up seconds, the trace of a traced run, the
    run's context and the card's peaks."""

    requests: List[Request]
    setup_s: float
    ctx: Ctx
    trace: Optional[object] = None
    peaks: Optional[dict] = None
