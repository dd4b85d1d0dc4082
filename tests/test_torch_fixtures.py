"""The port's fixture generator (`zkpoa_tpu_torch/pipeline/fixtures.py`, a
copy of `zkpoa_tpu/pipeline/fixtures.py`) against the JAX package's.

1. `deterministic_keys`, `generate_signatures`, `generate_anon_set` and
   `write_fixtures` give the JAX package's values and bytes for a few
   seeds and sizes.
2. `write_fixtures(2, extra=11)` and `write_fixtures(1, extra=12)`, the
   calls of the recursive runners, reproduce the recorded inputs
   `build/recursive_run2/{sigs.json,anon.csv}` and
   `build/recursive_run/{sigs.json,anon.csv}` byte for byte.
Exact comparisons throughout."""

import os

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU)

from zkpoa_tpu.pipeline import fixtures as jax_fixtures
from zkpoa_tpu_torch.pipeline import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,seed", [(1, "keys"), (3, "keys"), (4, "other-seed")])
def test_keys_and_signatures_equal_the_jax_packages(n, seed):
    assert fixtures.deterministic_keys(n, seed) == jax_fixtures.deterministic_keys(n, seed)
    sigs = fixtures.generate_signatures(n, seed=seed)
    assert sigs == jax_fixtures.generate_signatures(n, seed=seed)
    addrs = [int(e["address"], 16) for e in sigs]
    assert addrs == sorted(addrs) and len(set(addrs)) == n


@pytest.mark.parametrize("extra,seed", [(0, "anon"), (5, "anon"), (17, "keys")])
def test_anon_set_equals_the_jax_packages(extra, seed):
    owned = fixtures.generate_signatures(2)
    rows = fixtures.generate_anon_set(owned, extra=extra, seed=seed)
    assert rows == jax_fixtures.generate_anon_set(owned, extra=extra, seed=seed)
    assert len(rows) == 2 + extra and rows == sorted(rows)
    for e in owned:
        assert (int(e["address"], 16), int(e["balance"])) in rows


@pytest.mark.parametrize("n,extra,seed", [(1, 3, "keys"), (2, 6, "s2")])
def test_written_files_equal_the_jax_packages(tmp_path, n, extra, seed):
    paths = {}
    for name, mod in (("port", fixtures), ("jax", jax_fixtures)):
        sigs, anon = str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.csv")
        mod.write_fixtures(n, sigs, anon, extra=extra, seed=seed)
        paths[name] = (sigs, anon)
    for a, b in zip(paths["port"], paths["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("run,n_sigs", [("recursive_run2", 2), ("recursive_run", 1)])
def test_recorded_recursive_inputs_are_reproduced(tmp_path, run, n_sigs):
    sigs, anon = str(tmp_path / "sigs.json"), str(tmp_path / "anon.csv")
    fixtures.write_fixtures(n_sigs, sigs, anon, extra=13 - n_sigs)
    for mine, name in ((sigs, "sigs.json"), (anon, "anon.csv")):
        with open(mine, "rb") as f, open(os.path.join(REPO, "build", run, name), "rb") as g:
            assert f.read() == g.read(), name
