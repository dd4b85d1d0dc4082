"""zkpoa_tpu_torch row gathers (ops/gather.py, kernels E1-E3) against the
Pallas gather bodies of the JAX package's MSM stage harness.

The bodies `_vmem_gather_kernel`, `_vmem_take_kernel` and
`_dma_gather_kernel` of experiments/msm_stages.py run through
`pl.pallas_call(..., interpret=True)` with the harness's own specs
(msm_stages.py:91-99, :110-118, :150-163); its jitted wrappers pass no
`interpret` and need a TPU. The same numpy-seeded u32 table and indices go
to both sides; on CPU tensors the port's wrappers take the plain version.
Tolerance: exact equality (a gather moves bits)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zkpoa_tpu_torch.ops import gather as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = {"E1": G.gather_smem_rows, "E2": G.gather_smem_vec, "E3": G.gather_async}


@pytest.fixture(scope="module")
def jax_harness():
    """experiments/msm_stages.py imported by path; its import sets the JAX
    compile-cache variables, so the environment is restored after it."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_msm_stages", os.path.join(REPO, "experiments", "msm_stages.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


def _jax_gather(h, kind, tab, idx):
    """The harness's pallas_call of one body, in interpret mode."""
    m, w = idx.shape[0], tab.shape[1]
    out_shape = jax.ShapeDtypeStruct((m, w), jnp.uint32)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    if kind == "E1":
        call = pl.pallas_call(h._vmem_gather_kernel, out_shape=out_shape,
                              in_specs=[smem, vmem], out_specs=vmem, interpret=True)
    elif kind == "E2":
        call = pl.pallas_call(h._vmem_take_kernel, out_shape=out_shape,
                              in_specs=[vmem, vmem], out_specs=vmem, interpret=True)
    else:
        call = pl.pallas_call(
            h._dma_gather_kernel, out_shape=out_shape,
            in_specs=[smem, pl.BlockSpec(memory_space=pltpu.ANY)], out_specs=vmem,
            scratch_shapes=[pltpu.VMEM((8, w), jnp.uint32), pltpu.SemaphoreType.DMA((8,))],
            compiler_params=pltpu.CompilerParams(has_side_effects=True), interpret=True)
    return np.asarray(call(jnp.asarray(idx), jnp.asarray(tab)))


def _inputs(t, w, m, seed):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    idx = rng.integers(0, t, size=m, dtype=np.int32)
    idx[1] = idx[0]  # a repeated row
    idx[-1] = t - 1  # the last row
    return tab, idx


@pytest.mark.parametrize("w", [16, 128])
@pytest.mark.parametrize("kind", ["E1", "E2", "E3"])
def test_wrappers_equal_the_pallas_bodies(jax_harness, kind, w):
    tab, idx = _inputs(256, w, 64, seed=w)
    want = _jax_gather(jax_harness, kind, tab, idx)
    assert np.array_equal(want, tab[idx])
    t_tab, t_idx = torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)
    got = WRAPPERS[kind](t_tab, t_idx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (64, w)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(G.gather_rows_plain(t_tab, t_idx), got)


@pytest.mark.parametrize("m", [0, 1, 7])
def test_wrappers_below_the_ring_depth(m):
    """M < 8: the JAX E3 body starts 8 copies unconditionally, so only the
    plain route is compared, with numpy's take."""
    tab, _ = _inputs(32, 16, 8, seed=m)
    idx = np.arange(m, dtype=np.int32)[::-1].copy()
    t_tab, t_idx = torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)
    for fn in WRAPPERS.values():
        got = fn(t_tab, t_idx)
        assert tuple(got.shape) == (m, 16)
        assert np.array_equal(got.numpy().view(np.uint32), tab[idx])


def _bad_cases():
    ok_tab = torch.zeros((64, 16), dtype=torch.int32)
    ok_idx = torch.zeros(8, dtype=torch.int32)
    big = torch.zeros((G.SMEM_TABLE_MAX // 64 + 1, 16), dtype=torch.int32)  # > 227 KB
    return [
        ("E1", big, ok_idx, ValueError),
        ("E2", big, ok_idx, ValueError),
        ("E2", torch.zeros((64, 6), dtype=torch.int32), ok_idx, ValueError),
        ("E3", torch.zeros((64, 6), dtype=torch.int32), ok_idx, ValueError),
        ("E3", torch.zeros((64, 4096), dtype=torch.int32), ok_idx, ValueError),
        ("E1", ok_tab.to(torch.int64), ok_idx, TypeError),
        ("E2", ok_tab, ok_idx.to(torch.int64), TypeError),
        ("E3", ok_tab.t(), ok_idx, ValueError),
        ("E1", ok_tab[0], ok_idx, ValueError),
        ("E2", ok_tab[:0], ok_idx, ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_bad_cases())))
def test_wrappers_refuse_what_their_kernels_cannot_take(case):
    """Checked on any device, before the route is chosen: E1/E2 never hand a
    table above the shared-memory limit to index_select."""
    kind, tab, idx, err = _bad_cases()[case]
    with pytest.raises(err):
        WRAPPERS[kind](tab, idx)
