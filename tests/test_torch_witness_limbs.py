"""The witness upload's native conversion (`csrc/witness_limbs.c`, through
`host.py` `witness_limbs` and `prover/prove.py` `_upload`) and its build
(`_build.py` `build_host`, `host_lib`).

The conversion must give `host.scalars_to_limbs_fast([int(x) % R for x in
xs])` for every input: in-range ints take the native pass, everything else
the exact Python fallback, which `_upload` counts as `convert_fallback`."""

import os
import random
import shutil

import numpy as np
import pytest

from zkpoa_tpu_torch import _build, host
from zkpoa_tpu_torch.fields.bn254 import R
from zkpoa_tpu_torch.prover import prove as P
from zkpoa_tpu_torch.utils import trace


class Sub(int):
    pass


EDGES = [0, 1, 2**30 - 1, 2**30, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1, 2**64,
         2**128 + 3, R - 1, R, R + 1, 2**254, 2**256 + 5, -1, -R, -(2**70)]


def _mix(n=200_000, seed=18):
    """Values in the shares of a layer-one witness: 54 % zeros, 43 % one
    word (most of them 1), 2 % two words, 0.6 % full width, the rest three."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.54:
            out.append(0)
        elif u < 0.97:
            out.append(1 if rng.random() < 0.98 else rng.randrange(2, 2**64))
        elif u < 0.99:
            out.append(rng.randrange(2**64, 2**128))
        elif u < 0.994:
            out.append(rng.randrange(2**128, 2**192))
        else:
            out.append(rng.randrange(2**192, R))
    return out


def _want(xs):
    return host.scalars_to_limbs_fast([int(x) % R for x in xs])


CASES = {f"edge_{i}": [v] for i, v in enumerate(EDGES)}
CASES.update({
    "bool": [True, False, 5],
    "numpy_int64": [np.int64(7), 3],
    "int_subclass": [Sub(9), Sub(R + 4), 2],
    "empty": [],
    "list": list(EDGES),
    "tuple": tuple(EDGES),
    "range": range(2**62, 2**62 + 40, 3),
    "numpy_array": np.arange(-5, 20, dtype=np.int64),
    "mix": _mix(),
})


@pytest.mark.parametrize("name", list(CASES))
def test_native_conversion_equals_the_python_rule(name):
    xs = CASES[name]
    limbs, n_miss = host.witness_limbs(xs)
    want = _want(xs)
    assert limbs.dtype == want.dtype and limbs.shape == want.shape == (len(xs), host.N_LIMBS)
    assert np.array_equal(limbs, want)
    misses = sum(1 for x in xs if type(x) is not int or not 0 <= x < R)
    assert n_miss == misses


def _upload_events(xs):
    with trace.collect() as events:
        out = P._upload(xs, "cpu")
    return out, events


def _fallbacks(events):
    return [e for e in events if e["kind"] == "count" and e["name"] == "convert_fallback"]


def test_upload_counts_each_fallback_once_under_the_limbs_span():
    xs = [3, -1, R, True, 2**200, np.int64(4), Sub(8), 0]
    out, events = _upload_events(xs)
    assert np.array_equal(out.numpy(), _want(xs))
    fb, = _fallbacks(events)
    limbs, = [e for e in events if e["kind"] == "span" and e["name"] == "prove.upload.limbs"]
    assert (fb["n"], fb["site"], fb["span"]) == (5, "witness", limbs["id"])


def test_upload_of_an_all_in_range_witness_counts_no_fallback():
    xs = _mix(5_000, seed=7)
    out, events = _upload_events(xs)
    assert np.array_equal(out.numpy(), _want(xs))
    assert _fallbacks(events) == []
    assert [e["name"] for e in events if e["kind"] == "span"] == [
        "prove.upload.limbs", "prove.upload.copy"]


class Sized:
    """Has a length but no items: not a sequence."""

    def __len__(self):
        return 3


class BadIndex:
    def __index__(self):
        raise ArithmeticError("no value")


@pytest.mark.parametrize("witness,error", [
    (5, TypeError),
    (Sized(), TypeError),
    ([1, BadIndex(), 2], ArithmeticError),
])
def test_a_bad_witness_raises_before_any_copy(witness, error):
    with trace.collect() as events:
        with pytest.raises(error):
            P._upload(witness, "cpu")
    assert [e["name"] for e in events] == ["prove.upload.limbs"]


def test_native_pass_rejects_a_buffer_of_another_length():
    limbs = np.empty((2, host.N_LIMBS), dtype=np.int32)
    miss = np.empty(2, dtype=np.int64)
    with pytest.raises(ValueError, match="3 values"):
        _build.host_lib().zk_witness_limbs([1, 2, 3], 2, limbs.ctypes.data, miss.ctypes.data)


def test_host_library_is_built_once_and_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    path = _build.build_host()
    assert os.path.basename(path) == f"libzkpoa_host_{_build.host_digest()}.so"
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    stamp = os.stat(path).st_mtime_ns

    def no_compiler(*args, **kwargs):
        raise AssertionError("recompiled")

    monkeypatch.setattr(_build.subprocess, "run", no_compiler)
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    assert _build.build_host() == path and os.stat(path).st_mtime_ns == stamp
    assert _build.host_lib() is _build.host_lib()
    assert _build.host_lib()._name == path


def test_a_changed_source_gives_a_new_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    before = _build.build_host()
    src = tmp_path / "witness_limbs.c"
    shutil.copy(_build.HOST_SOURCE, src)
    with open(src, "a") as f:
        f.write("\n/* changed */\n")
    digest = _build.host_digest()
    monkeypatch.setattr(_build, "HOST_SOURCE", str(src))
    assert _build.host_digest() != digest
    after = _build.build_host()
    assert after != before and os.path.exists(before) and os.path.exists(after)


def test_the_cuda_library_digest_ignores_the_host_source(tmp_path, monkeypatch):
    assert all(p.endswith((".cu", ".cuh")) for p in _build._sources())
    digest = _build.source_digest()
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    os.remove(csrc / os.path.basename(_build.HOST_SOURCE))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert _build.source_digest() == digest

