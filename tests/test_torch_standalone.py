"""The port stands alone, and its copy of the circuit frontend builds the
JAX package's circuits.

1. No file of `zkpoa_tpu_torch/`, and not `chip_smoke.py`, imports `jax` or
   any `zkpoa_tpu` module (an AST scan of every import statement).
2. In a fresh process where `jax` and `zkpoa_tpu` cannot be imported (a
   `sys.meta_path` finder refuses them, as on a machine without JAX), the
   port builds the layer-two circuit of the recorded two-signature run.
3. The port's layer-two circuit (that run's batch-0 input, height 5) and
   layer-three circuit (full mode, balances [419, 238]) equal
   `zkpoa_tpu`'s exactly: constraint and wire counts, public count, packed
   rows (constraint, wire, coefficient) and witness integers.
4. Every copied module whose first line says that only its imports are
   rewritten (`COPIED`, among them `pipeline/fixtures.py`) equals its
   original line for line once the import lines are set aside."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2_INPUT = os.path.join(REPO, "build", "recursive_run2", "2_sigs_2_batches_5_height",
                        "batch_0", "layer_two_input.json")
ROOT = 1347294174218695222215792684608056932901521774908248407985864526105711707597
BLIND = 0xB11DD1E5


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "zkpoa_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zkpoa_tpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


_BLOCKED_BUILD = r"""
import importlib.abc, json, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "zkpoa_tpu"):
            raise ImportError(f"refused: {name}")
sys.meta_path.insert(0, Refuse())
from zkpoa_tpu_torch.models.layers import LayerTwoInput, layer_two_circuit
d = json.load(open(sys.argv[1]))
d.pop("proof", None)
ints = lambda x: [ints(y) for y in x] if isinstance(x, list) else int(x)
r1cs, wit = layer_two_circuit(LayerTwoInput(**{k: ints(v) for k, v in d.items()}),
                              tree_height=5).compile()
assert not any(m.split(".")[0] in ("jax", "zkpoa_tpu") for m in sys.modules)
print(r1cs.n_constraints, r1cs.n_wires)
"""


def test_layer_two_builds_with_jax_refused():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _BLOCKED_BUILD, L2_INPUT], env=env, cwd="/",
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["191871", "191877"]


def _layer_two(layers):
    with open(L2_INPUT) as f:
        d = json.load(f)
    d.pop("proof", None)
    ints = lambda x: [ints(y) for y in x] if isinstance(x, list) else int(x)  # noqa: E731
    inp = layers.LayerTwoInput(**{k: ints(v) for k, v in d.items()}, proof=None)
    return layers.layer_two_circuit(inp, tree_height=5)


def _layer_three(layers):
    return layers.layer_three_circuit([419, 238], ROOT, BLIND)


def _packed_ints(packed, from_limbs):
    mats = [(m.idx.tolist(), m.wire.tolist(), m.cid.tolist()) for m in (packed.a, packed.b, packed.c)]
    return mats, from_limbs(packed.pool_limbs)


@pytest.mark.parametrize("build", [_layer_two, _layer_three], ids=["layer_two", "layer_three"])
def test_frontend_copy_builds_the_jax_packages_circuit(build):
    from zkpoa_tpu.models import layers as jax_layers
    from zkpoa_tpu.ops.limbs import BN254_FR as JFR
    from zkpoa_tpu_torch.models import layers
    from zkpoa_tpu_torch.ops.limbs import BN254_FR

    c_port, c_jax = build(layers), build(jax_layers)
    (r_port, w_port), (r_jax, w_jax) = c_port.compile(), c_jax.compile()
    for k in ("n_constraints", "n_wires", "n_public"):
        assert getattr(r_port, k) == getattr(r_jax, k), k
    assert w_port == w_jax
    assert c_port.public_values == c_jax.public_values
    port = _packed_ints(r_port.pack(), BN254_FR.from_limbs)
    jax_ = _packed_ints(r_jax.pack(), lambda a: [int(x) for x in JFR.from_limbs(a)])
    assert port == jax_


def _copy_header(path):
    with open(path) as f:
        return f.readline()


# the port's modules copied with only their imports rewritten
COPIED = sorted(
    os.path.relpath(p, REPO) for p in _port_files()
    if _copy_header(p).startswith("# Copy of ") and "only its imports are rewritten" in _copy_header(p)
)


def _without_imports(lines):
    return [ln for ln in lines if not re.match(r"\s*(from \S+ import |import \S)", ln)]


def test_copied_module_list():
    assert "zkpoa_tpu_torch/pipeline/fixtures.py" in COPIED
    assert "zkpoa_tpu_torch/utils/binfmt.py" in COPIED
    assert len(COPIED) >= 19


@pytest.mark.parametrize("copy", COPIED)
def test_copied_module_equals_its_original_apart_from_imports(copy):
    with open(os.path.join(REPO, copy)) as f:
        header, *body = f.read().splitlines()
    original = re.match(r"# Copy of (\S+);", header).group(1)
    with open(os.path.join(REPO, original)) as f:
        want = f.read().splitlines()
    assert _without_imports(body) == _without_imports(want)
