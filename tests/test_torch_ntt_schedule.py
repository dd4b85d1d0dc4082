"""The schedule of the stage-blocked NTT kernel (csrc/ntt.cu) in its plain
version, `zkpoa_tpu_torch.ops.ntt.ntt_passes_plain`, on the CPU: the same
tiles, butterfly pairs, twiddle indices and last-pass scales as the
kernel, at tile logs t in {1, 2, 3, 11} (so log_n < t, log_n = t and
log_n % t != 0 all occur), against the JAX package's `ntt`,
`coset_qap_evals` and `quotient` (zkpoa_tpu/ops/ntt.py) and the port's
per-stage `ntt_plain`. Inputs are numpy-seeded; tolerance zero (decoded
integers equal)."""

import math

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu.fields.bn254 import R
from zkpoa_tpu.ops import ntt as JN
from zkpoa_tpu.ops.limbs import BN254_FR as JFR
from zkpoa_tpu_torch.ops import ntt as N
from zkpoa_tpu_torch.ops.limbs import BN254_FR

torch.set_num_threads(1)

LOG_NS = [1, 2, 3, 5, 8, 11, 12]
TILE_LOGS = [1, 2, 3, 11]
_JAX = {}  # (log_n, what) -> decoded integers of the JAX package's result


def _values(log_n, k=0):
    rng = np.random.default_rng(100 * log_n + k)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(1 << log_n)]


def _jax(log_n, what):
    key = (log_n, what)
    if key not in _JAX:
        ev = [JFR.encode(_values(log_n, k)) for k in range(3)]
        if what == "fwd":
            out = JN.ntt(ev[0])
        elif what == "inv":
            out = JN.ntt(ev[0], inverse=True)
        elif what == "coset":
            out = JN.coset_qap_evals(*ev)
        else:
            out = JN.quotient(*ev)
        _JAX[key] = [int(v) for v in JFR.decode(out)]
    return _JAX[key]


def _enc(log_n, k=0):
    return BN254_FR.encode(_values(log_n, k), "cpu")


@pytest.mark.parametrize("log_n", [0] + LOG_NS + [21, 23])
@pytest.mark.parametrize("t", TILE_LOGS)
def test_pass_schedule_covers_every_stage_once(log_n, t):
    passes = N.ntt_passes(log_n, t)
    assert len(passes) == max(1, math.ceil(log_n / t))
    assert [s0 for s0, _w, _c in passes] == list(range(0, max(log_n, 1), t))[: len(passes)]
    assert sum(w for _s0, w, _c in passes) == log_n
    for s0, w, log_c in passes:
        assert 0 <= log_c <= s0 and w + log_c <= t and s0 + w <= log_n
    assert N.ntt_passes(21, N.TILE_LOG) == [(0, 11, 0), (11, 10, 1)]  # the main path's


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("t", TILE_LOGS)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_pass_schedule_matches_jax_ntt(log_n, t, inverse):
    x = _enc(log_n)
    scale = BN254_FR.encode([pow(1 << log_n, -1, R)], "cpu") if inverse else None
    got = BN254_FR.decode(N.ntt_passes_plain(x, inverse, scale, tile_log=t))
    assert got == _jax(log_n, "inv" if inverse else "fwd")
    if t == 1:
        assert BN254_FR.decode(N.ntt_plain(x, inverse)) == got


@pytest.mark.parametrize("t", TILE_LOGS)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_quotient_and_coset_evals_match_jax(log_n, t, monkeypatch):
    """The quotient's transforms with their folded scales (1/n and g^i after
    each inverse transform; g^-i / (n Z(g)) after the last) in tiles of
    2^t: equal to the JAX package's unfolded products."""
    monkeypatch.setattr(N, "TILE_LOG", t)
    ev = [_enc(log_n, k) for k in range(3)]
    assert BN254_FR.decode(N.coset_qap_evals(*ev)) == _jax(log_n, "coset")
    assert BN254_FR.decode(N.quotient(*ev)) == _jax(log_n, "quot")


@pytest.mark.parametrize("log_n,t", [(5, 2), (8, 3), (12, 11)])
def test_last_pass_scales_equal_products_after_the_transform(log_n, t):
    x = _enc(log_n)
    c = _values(log_n, 7)[:1]
    tab = _values(log_n, 8)
    want = BN254_FR.decode(N.ntt_plain(x))
    got_c = N.ntt_passes_plain(x, False, BN254_FR.encode(c, "cpu"), tile_log=t)
    assert BN254_FR.decode(got_c) == [v * c[0] % R for v in want]
    got_t = N.ntt_passes_plain(x, False, BN254_FR.encode(tab, "cpu"), tile_log=t)
    assert BN254_FR.decode(got_t) == [v * s % R for v, s in zip(want, tab)]


def test_kernel_launcher_refuses_what_it_cannot_take():
    """ntt_kernel raises (no plain fallback) on a CPU tensor, a wrong dtype,
    a size that is not a power of two, a misshapen scale and a tile log
    outside 1..11."""
    x = _enc(3)
    with pytest.raises(ValueError, match="CUDA"):
        N.ntt_kernel(x)
    with pytest.raises(TypeError):
        N.ntt_kernel(x.to(torch.int64))
    with pytest.raises(ValueError, match="power of two"):
        N.ntt_kernel(x[:6].contiguous())
    with pytest.raises(ValueError):
        N.ntt_kernel(x.view(2, 4, 8))
    with pytest.raises(ValueError):
        N.ntt_kernel(x, scale=x[:3])
    with pytest.raises(ValueError):
        N.ntt_passes(3, 12)
    with pytest.raises(ValueError):
        N.ntt_passes_plain(x, tile_log=0)
