"""The NTT and MSM work reckonings against hand counts at small sizes."""

import types

import numpy as np
import pytest

from poa_bench.pool import Request
from poa_bench.reference.groth16 import Statement
from poa_bench.work import msm_pippenger as W
from poa_bench.work import ntt_quotient

MONT = 256


def ctx_of(n_constraints, witness, entries, n_public=1):
    stmt = Statement(entries={k: tuple(np.asarray(x, dtype=np.int64) for x in v)
                              for k, v in entries.items()},
                     pool=[1], n_constraints=n_constraints, n_wires=len(witness),
                     n_public=n_public)
    pool = types.SimpleNamespace(statement=lambda: stmt, witnesses=[witness])
    return types.SimpleNamespace(pool=pool, memo={})


def req0():
    return Request(i=0, wi=0, r=1, s=1, t_start=0.0)


@pytest.mark.parametrize("n_constraints,m", [(5, 8), (8, 8), (1000, 1024), (1816064, 1 << 21)])
def test_ntt_work_is_seven_transforms_of_the_domain(n_constraints, m):
    ctx = ctx_of(n_constraints, [1, 0], {k: ([], [], []) for k in "abc"})
    ops, n_bytes = ntt_quotient.work(ctx, req0())
    log_m = m.bit_length() - 1
    assert ops == 7 * (m // 2) * log_m * MONT
    assert n_bytes == 7 * 2 * 32 * m


def test_pippenger_picks_the_least_count():
    assert W.pippenger_ops(np.array([], dtype=np.int64)) == 0
    # one 3-bit value: c = 3 gives 1 digit (share 7/8), 8 reduction adds, no combine
    bits = np.array([3])
    c3 = 1 * (1 - 2 ** -3) + 8
    c1 = 3 * 0.5 + 3 * 2 + 2 + 2
    c2 = 2 * 0.75 + 2 * 4 + 1 + 2
    assert W.pippenger_ops(bits) == pytest.approx(min(c1, c2, c3))


def test_msm_counts_zero_one_repeated_and_distinct_scalars():
    # wires: 0 -> 1, 1 -> 0, 2 -> 1, 3 -> 5 (twice), 4 -> 5, 5 -> 9 (once)
    witness = [1, 0, 1, 5, 5, 9]
    ids = np.arange(6)
    ids_cls, bits, ones = W._classes(ctx_of(4, witness, {k: ([], [], []) for k in "abc"}), 0)
    every = np.ones(6, dtype=bool)
    ops = W.msm_ops(ids_cls, bits, ones, every)
    # ones: 2 additions; 5 twice: 1 addition, then 5 = 101b: 2 doublings + 1 addition; 9 once
    assert ops == pytest.approx(2 + (1 + 2 + 1) + W.pippenger_ops(np.array([4])))
    only_zero = np.zeros(6, dtype=bool)
    only_zero[1] = True
    assert W.msm_ops(ids_cls, bits, ones, only_zero) == 0
    assert W.msm_ops(ids_cls, bits, ones, ids == 3) == W.pippenger_ops(np.array([3]))


def test_msm_work_over_the_queries():
    witness = [1, 7, 0, 3, 3]  # wire 1 public
    entries = {"a": ([0, 1], [1, 3], [0, 0]), "b": ([0], [4], [0]), "c": ([1], [0], [0])}
    ctx = ctx_of(2, witness, entries)
    ops, n_bytes = W.work(ctx, req0())
    m = 2
    g1 = (W.pippenger_ops(np.array([3, 2]))  # a: wires 1 (7) and 3 (3), each once
          + W.pippenger_ops(np.array([2]))  # b1: wire 4 (3)
          + W.pippenger_ops(np.array([2]))  # c: private wires with entries: 3 and 4 share 3
          - W.pippenger_ops(np.array([2])) + (1 + 1 + 1)  # ... so one sum, then 3 = 11b
          + W.pippenger_ops(np.full(m - 1, 254)))
    g2 = W.pippenger_ops(np.array([2]))
    assert ops == pytest.approx((6 * g1 + 18 * g2) * MONT)
    points = 2 + 1 + 2 + (m - 1)
    assert n_bytes == 64 * points + 128 * 1 + 32 * (5 + m - 1)
