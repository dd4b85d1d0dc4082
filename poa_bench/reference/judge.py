"""The comparison that decides `correct`.

Every proof the window completed is held against the reference's proof
of the same witness, key seed and (r, s), element by element: a proof is
wrong if pi_a, pi_b or pi_c differs. A request whose call raised has no
answer and counts as missing. The public values of every witness in the
pool are held against those the reference works out from the raw seeds.
The number compared is their sum, `answers_wrong`, with the limit 0: the
arithmetic is exact, and any one of them is a wrong answer.

The control is this reference in the program's place with one guarantee
broken: every witness value cut to its low TOP_BITS bits, as an MSM that
skipped its top partial window would take it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

from .groth16 import Statement, dev_trapdoors, proof_points, proof_scalars, qap_at_tau

LIMITS = {"answers_wrong": 0}
TOP_BITS = 252


class Expected:
    """The reference's proofs of a pool of witnesses under a dev key."""

    def __init__(self, stmt: Statement, witnesses: Sequence[Sequence[int]], key_seed: str,
                 device):
        self.td = dev_trapdoors(key_seed)
        self.qap = qap_at_tau(stmt, witnesses, self.td["tau"], device)
        self._memo: Dict[Tuple[int, int, int], tuple] = {}

    def points(self, wi: int, r: int, s: int) -> tuple:
        key = (wi, r, s)
        if key not in self._memo:
            self._memo[key] = proof_points(proof_scalars(self.qap[wi], self.td, r, s))
        return self._memo[key]


def expected_publics(kind: str, raw: dict) -> List[int]:
    return importlib.import_module(f"{__package__}.{kind}").expected_publics(raw)


def judge(expected: Expected, answers, witnesses, n_public: int,
          publics: Sequence[Sequence[int]]) -> Dict[str, int]:
    """answers: (witness index, r, s, (pi_a, pi_b, pi_c) or None) each."""
    wrong = missing = 0
    for wi, r, s, pts in answers:
        if pts is None:
            missing += 1
        elif tuple(pts) != expected.points(wi, r, s):
            wrong += 1
    pub_wrong = 0
    for w, want in zip(witnesses, publics):
        got = [int(x) for x in w[1: 1 + n_public]]
        pub_wrong += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    return {"proofs_wrong": wrong, "answers_missing": missing, "publics_wrong": pub_wrong}


def control_answers(stmt: Statement, witnesses, key_seed: str, device, requests):
    """The control's answers to the same requests: the reference's proofs
    of the witnesses cut to TOP_BITS bits."""
    mask = (1 << TOP_BITS) - 1
    ctrl = Expected(stmt, [[int(x) & mask for x in w] for w in witnesses], key_seed, device)
    return [(wi, r, s, ctrl.points(wi, r, s)) for wi, r, s, _ in requests]


def compared(parts: Dict[str, int]) -> Dict[str, int]:
    """The numbers held against LIMITS, from the counts `judge` gives."""
    return {"answers_wrong": sum(parts.values())}


def is_correct(parts: Dict[str, int]) -> bool:
    return all(v <= LIMITS[k] for k, v in compared(parts).items())
