"""Rank bodies of the port's multi-process tests (`tests/test_torch_parallel*.py`).

    python tests/torch_ranks.py JOB_DIR RANK

One process a rank, on the CPU over gloo, started by the test with a
`file://` store in JOB_DIR. JOB_DIR/job.pt holds the world size, the names
of the bodies to run (`BODIES`) and their inputs; each rank writes what
every body returned to JOB_DIR/out<RANK>.pt. This file imports only the
port (no `jax`, no `zkpoa_tpu`), so a child never loads JAX: the tests
compute the JAX package's references in their own process.
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch.distributed as dist  # noqa: E402

from zkpoa_tpu_torch import host  # noqa: E402
from zkpoa_tpu_torch.fields import bn254  # noqa: E402
from zkpoa_tpu_torch.ops.curve import BN254_G1, DeviceG1Points  # noqa: E402
from zkpoa_tpu_torch.parallel import batch_prove, ntt_dist  # noqa: E402
from zkpoa_tpu_torch.parallel import mesh as PM  # noqa: E402


def _table(mults):
    """P_i = g_i G as a G1 table on the CPU."""
    return DeviceG1Points(*BN254_G1.encode_affine([bn254.g1_mul(bn254.G1_GEN, k) for k in mults],
                                                  "cpu"))


def _limbs(scalars):
    return torch.from_numpy(host.scalars_to_limbs_fast(scalars))


def quotient_dist(job):
    mesh = PM.make_mesh(axis="data", device="cpu")
    return [ntt_dist.quotient_dist(*ops, mesh) for ops in job["quotient_inputs"]]


def msm_sharded(job):
    mesh = PM.make_mesh(axis="data", device="cpu")
    return PM.msm_sharded(BN254_G1, _table(job["mults"]), _limbs(job["scalars"][0]), mesh)


def msm_batch_sharded(job):
    mesh = PM.make_hierarchical_mesh(shape=(2, dist.get_world_size() // 2), device="cpu")
    scalars = torch.stack([_limbs(s) for s in job["scalars"][:2]])
    return PM.msm_batch_sharded(BN254_G1, _table(job["mults"]), scalars, mesh)


def msm_batch_parallel(job):
    mesh = PM.make_mesh(axis="batch", device="cpu")
    scalars = torch.stack([_limbs(s) for s in job["scalars"][:dist.get_world_size()]])
    return batch_prove.msm_batch_parallel(BN254_G1, _table(job["mults"]), scalars, mesh)


def mesh_placement(job):
    """shard_leading's block and replicate's broadcast of rank 0's tensor."""
    mesh = PM.make_mesh(axis="data", device="cpu")
    rank = dist.get_rank()
    x = torch.arange(4 * dist.get_world_size()).reshape(-1, 1) + 100 * rank
    return {"block": PM.shard_leading({"x": x}, mesh)["x"],
            "replicated": PM.replicate([x], mesh)[0]}


def prove_many_route(job):
    """The workflow's `_prove_many` with stubs for both routes: which one
    it takes, and the mesh it gives `prove_batched`."""
    from zkpoa_tpu_torch.pipeline import workflow

    calls = []

    def batched(pk, r1cs, wits, mesh, seeds=None, axis="batch"):
        calls.append({"axis_size": PM.axis_size(mesh, axis), "axis": axis,
                      "in_mesh": mesh.get_coordinate() is not None, "seeds": list(seeds)})
        return ["batched"] * len(wits)

    workflow.prove_batched, workflow.prove = batched, lambda *a, **k: "sequential"
    return {"two": workflow._prove_many(None, None, [[1], [2]], ["s0", "s1"], "cpu"),
            "one": workflow._prove_many(None, None, [[1]], ["s0"], "cpu"), "calls": calls}


def prove_batched(job):
    """prove_batched of the first n witnesses for each n of the job's
    counts, and of all of them a witness at a time (chunk 1); the error
    when the last rank's key differs; then the sequential prove of the
    witnesses the job gives this rank (`sequential`: witness -> rank) for
    the test to gather."""
    import dataclasses

    from zkpoa_tpu_torch.prover.prove import prove

    pk, r1cs, wits = job["pk"], job["r1cs"], job["witnesses"]
    mesh = PM.make_mesh(axis="batch", device="cpu")
    out = {n: batch_prove.prove_batched(pk, r1cs, wits[:n], mesh, seed="bp")
           for n in job["counts"]}
    chunk, batch_prove.CHUNK = batch_prove.CHUNK, 1
    out["chunk1"] = batch_prove.prove_batched(pk, r1cs, wits, mesh, seed="bp")
    batch_prove.CHUNK = chunk
    other = dataclasses.replace(pk, vk_json={**pk.vk_json, "rank": dist.get_rank()})
    try:
        batch_prove.prove_batched(other if dist.get_rank() == dist.get_world_size() - 1 else pk,
                                  r1cs, wits[:2], mesh, seed="bp")
        out["other_key"] = None
    except ValueError as e:
        out["other_key"] = str(e)
    out["sequential"] = {i: prove(pk, r1cs, wits[i], "cpu", seed=f"bp-b{i}")
                         for i, r in job["sequential"].items() if r == dist.get_rank()}
    return out


BODIES = {f.__name__: f for f in (quotient_dist, msm_sharded, msm_batch_sharded,
                                  msm_batch_parallel, mesh_placement, prove_many_route,
                                  prove_batched)}


def start(job_dir: str, job: dict) -> list:
    """Write the job and start its ranks (not waiting for them)."""
    import subprocess

    torch.save(job, os.path.join(job_dir, "job.pt"))
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(job_dir), str(r)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(job["world"])]


def finish(job_dir: str, procs: list, timeout: float = 600) -> list:
    """Wait for every rank; each rank's outputs, in rank order. Fails with
    a rank's output when it exits with an error; stops every rank on a
    timeout."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(os.path.join(job_dir, f"out{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def main(job_dir: str, rank: int) -> int:
    torch.set_num_threads(1)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    world = PM.init_multihost(f"file://{os.path.join(job_dir, 'store')}", job["world"], rank,
                              device="cpu")
    assert world == job["world"] and dist.get_rank() == rank
    out = {name: BODIES[name](job) for name in job["run"]}
    torch.save(out, os.path.join(job_dir, f"out{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
