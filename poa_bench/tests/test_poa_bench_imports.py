"""Nothing in the benchmark imports JAX or the JAX package; the reference
imports nothing of the program; the command refuses a run that loaded
either."""

import ast
import os
import sys

import pytest

from poa_bench import run

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "zkpoa_tpu"}


def modules(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(modules("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_program(path):
    assert "zkpoa_tpu_torch" not in set(top_level_imports(path))


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "zkpoa_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "zkpoa_tpu_torch.prover", sys)
    assert "zkpoa_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zkpoa_tpu.ops", sys)
    assert "zkpoa_tpu" in run.forbidden_modules()


def test_command_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    result = {"correct": True, "checks": {}}
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: result)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.main(["--workload", "l1_b2.prove", "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
