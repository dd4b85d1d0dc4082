"""The port's workflow CLI over two ranks on the CPU, started as
`torchrun --nproc-per-node 2` starts them (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT in each process's
environment; gloo, as `--device cpu` asks), beside a single-process run of
the same command: accounting mode, 2 fixture signatures
(`zkpoa_tpu_torch.pipeline.fixtures`), batch size 1, tree height 3. Rank 0's
build directory must hold the same files as the single run's, with the
same Merkle root, balance sum and layer-three public values, and
byte-identical proof.json files; its layer-two batches go through
`prove_batched` (no per-phase `prove:` lines, which only the sequential
prove logs, before layer three's); rank 1 logs nothing and leaves nothing
in the output directory. Both runs cache their keys (`-z`): the two ranks
share one cache, which rank 0 alone writes, so it ends holding the files
the single run's cache holds."""

import os
import socket
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU)
from zkpoa_tpu_torch.pipeline import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLIND = "0xB11DD1E5"
OUT = "2_sigs_2_batches_3_height"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wf2")
    sigs, anon = str(d / "sigs.json"), str(d / "anon.csv")
    fixtures.write_fixtures(2, sigs, anon, extra=2)
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def cli(build):
        return [sys.executable, "-m", "zkpoa_tpu_torch.pipeline.workflow", sigs, anon, BLIND,
                "-p", "1", "-m", "accounting", "-H", "3", "--device", "cpu", "-b", str(d / build),
                "-z", str(d / f"{build}_zkeys")]

    port = str(_free_port())
    procs = [subprocess.Popen(cli("single"), env=env, cwd=str(d), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    for rank in range(2):
        renv = dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                    LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(cli("multi"), env=renv, cwd=str(d), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, f"{p.args}: exit {p.returncode}\n{out[-3000:]}\n{err}"
    return d, [out for out, _ in logs]


def _read(path):
    with open(path) as f:
        return f.read()


def test_rank_zero_writes_what_one_process_writes(runs):
    d, _ = runs
    single, multi = d / "single" / OUT, d / "multi" / OUT
    files = _files(single)
    assert "layer_three/proof.json" in files and _files(multi) == files
    for name in ("merkle_root.json", "merkle_proofs.json", "batch_0/public.json",
                 "batch_1/public.json", "layer_three/public.json", "layer_three/commitment.json"):
        assert _read(multi / name) == _read(single / name), name


@pytest.mark.parametrize("proof", ["batch_0/proof.json", "batch_1/proof.json",
                                   "layer_three/proof.json"])
def test_proofs_are_byte_identical(runs, proof):
    d, _ = runs
    assert _read(d / "multi" / OUT / proof) == _read(d / "single" / OUT / proof)


def test_batches_prove_batched_and_rank_one_is_silent(runs):
    _, (single_log, rank0_log, rank1_log) = runs
    assert rank1_log == ""
    for log in (single_log, rank0_log):
        assert "workflow OK" in log
    l2 = lambda log: log[log.index("layer2 prove"):log.index("layer3 build")]  # noqa: E731
    assert "prove: witness upload" in l2(single_log)
    assert "prove: witness upload" not in l2(rank0_log)
    assert "prove: witness upload" in rank0_log[rank0_log.index("layer3 prove"):]


def test_ranks_share_one_key_cache_that_rank_zero_writes(runs):
    d, _ = runs
    keys = sorted(os.listdir(d / "single_zkeys"))
    assert keys and all(k.endswith(".pt") for k in keys)
    assert sorted(os.listdir(d / "multi_zkeys")) == keys
