"""The port's multi-rank modules (`zkpoa_tpu_torch/parallel/`) on the CPU,
over 2 and 4 gloo processes (`tests/torch_ranks.py`, one process a rank,
a `file://` store in the test's directory), against the one-device
results and the JAX package (zkpoa_tpu/parallel/, computed in this
process; the ranks import no JAX):

* `ntt_dist.quotient_dist` for n in {64, 256}: limb for limb the port's
  `ops.ntt.quotient`, and the JAX package's `quotient` decoded to integers
  (as tests/test_ntt_dist.py:20);
* `mesh.msm_sharded` and `batch_prove.msm_batch_parallel`: with
  P_i = g_i G the sum is (sum s_i g_i mod r) G on every rank;
* `mesh.msm_batch_sharded` on a (2, 2) mesh (batches over "batch", points
  over "data"), as tests/test_batch_prove.py:40;
* `mesh.shard_leading` and `mesh.replicate`;
* the workflow's `_prove_many`: `prove_batched` over a "batch" mesh of
  min(world, witnesses) ranks when a group of more than one rank is up and
  there is more than one witness, `prove` in turn otherwise (both stubbed).
Inputs are numpy-seeded; all exact."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import tests.torch_ranks as ranks
from zkpoa_tpu.fields.bn254 import R
from zkpoa_tpu.ops.limbs import BN254_FR as JFR
from zkpoa_tpu.ops.ntt import quotient as jax_quotient
from zkpoa_tpu_torch.fields import bn254
from zkpoa_tpu_torch.ops.limbs import BN254_FR
from zkpoa_tpu_torch.ops.ntt import quotient
from zkpoa_tpu_torch.pipeline import workflow

torch.set_num_threads(1)

WORLDS = [2, 4]
QUOTIENT_NS = [64, 256]
N_POINTS = 16


def _quotient_ints(n):
    rng = np.random.default_rng(11)
    a = [int.from_bytes(rng.bytes(31), "big") % R for _ in range(n)]
    b = [int.from_bytes(rng.bytes(31), "big") % R for _ in range(n)]
    return a, b, [x * y % R for x, y in zip(a, b)]  # C = A*B: divisible by Z


def _msm_inputs():
    rng = np.random.default_rng(3)
    mults = [int(k) + 1 for k in rng.integers(1, 1 << 20, size=N_POINTS)]
    scalars = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(N_POINTS)]
               for _ in range(4)]
    return mults, scalars


def _msm_want(mults, scalars):
    return bn254.g1_mul(bn254.G1_GEN, sum(s * m for s, m in zip(scalars, mults)) % R)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, started together; {world: [outputs by rank]}."""
    mults, scalars = _msm_inputs()
    inputs = [tuple(BN254_FR.encode(v, "cpu") for v in _quotient_ints(n)) for n in QUOTIENT_NS]
    procs = {}
    for world in WORLDS:
        run = ["quotient_dist", "msm_sharded", "msm_batch_parallel", "mesh_placement",
               "prove_many_route"] + (["msm_batch_sharded"] if world == 4 else [])
        job_dir = tmp_path_factory.mktemp(f"world{world}")
        job = {"world": world, "run": run, "quotient_inputs": inputs, "mults": mults,
               "scalars": scalars}
        procs[world] = (job_dir, ranks.start(str(job_dir), job))
    return {world: ranks.finish(str(d), p) for world, (d, p) in procs.items()}


@pytest.mark.parametrize("n", QUOTIENT_NS)
@pytest.mark.parametrize("world", WORLDS)
def test_quotient_dist_equals_one_device_and_jax(runs, world, n):
    ops = _quotient_ints(n)
    want = quotient(*(BN254_FR.encode(v, "cpu") for v in ops))
    jax_ints = [int(v) for v in JFR.decode(jax_quotient(*(JFR.encode(v) for v in ops)))]
    assert BN254_FR.decode(want) == jax_ints
    for out in runs[world]:
        got = out["quotient_dist"][QUOTIENT_NS.index(n)]
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_msm_sharded_is_exact_on_every_rank(runs, world):
    mults, scalars = _msm_inputs()
    for out in runs[world]:
        assert out["msm_sharded"] == _msm_want(mults, scalars[0])


@pytest.mark.parametrize("world", WORLDS)
def test_msm_batch_parallel_is_exact_on_every_rank(runs, world):
    mults, scalars = _msm_inputs()
    for out in runs[world]:
        assert out["msm_batch_parallel"] == [_msm_want(mults, s) for s in scalars[:world]]


def test_msm_batch_sharded_on_a_2x2_mesh(runs):
    mults, scalars = _msm_inputs()
    for out in runs[4]:
        assert out["msm_batch_sharded"] == [_msm_want(mults, s) for s in scalars[:2]]


@pytest.mark.parametrize("world", WORLDS)
def test_shard_leading_and_replicate(runs, world):
    for rank, out in enumerate(runs[world]):
        x = torch.arange(4 * world).reshape(-1, 1)
        assert torch.equal(out["mesh_placement"]["block"], x[4 * rank:4 * rank + 4] + 100 * rank)
        assert torch.equal(out["mesh_placement"]["replicated"], x)


@pytest.mark.parametrize("world", WORLDS)
def test_prove_many_batches_only_over_several_ranks(runs, world):
    for rank, out in enumerate(runs[world]):
        route = out["prove_many_route"]
        assert route["two"] == ["batched", "batched"] and route["one"] == ["sequential"]
        assert route["calls"] == [{"axis_size": 2, "axis": "batch", "in_mesh": rank < 2,
                                   "seeds": ["s0", "s1"]}]


def test_prove_many_proves_in_turn_without_a_process_group(monkeypatch):
    monkeypatch.setattr(workflow, "prove_batched",
                        lambda *a, **k: pytest.fail("prove_batched without a process group"))
    monkeypatch.setattr(workflow, "prove", lambda pk, r1cs, w, device, seed, log: (w, seed))
    assert workflow._prove_many(None, None, [[1], [2]], ["s0", "s1"], "cpu") == [
        ([1], "s0"), ([2], "s1")]
