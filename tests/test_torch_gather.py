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
WRAPPERS = {"E1": G.gather_smem_rows, "E2": G.gather_vec, "E3": G.gather_async}


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
        ("E3", ok_tab, ok_idx[None], ValueError),  # idx not [M]
        ("E2", torch.zeros((64, 6), dtype=torch.int32), ok_idx, ValueError),
        ("E3", torch.zeros((64, 6), dtype=torch.int32), ok_idx, ValueError),
        ("E3", torch.zeros((2, G.ASYNC_W_MAX + 4), dtype=torch.int32), ok_idx, ValueError),
        ("E1", ok_tab.to(torch.int64), ok_idx, TypeError),
        ("E2", ok_tab, ok_idx.to(torch.int64), TypeError),
        ("E3", ok_tab.t(), ok_idx, ValueError),
        ("E1", ok_tab[0], ok_idx, ValueError),
        ("E2", ok_tab[:0], ok_idx, ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_bad_cases())))
def test_wrappers_refuse_what_their_kernels_cannot_take(case):
    """Checked on any device, before the route is chosen: E1 never hands a
    table above the shared-memory limit to index_select, nor E3 rows too
    wide for its ring."""
    kind, tab, idx, err = _bad_cases()[case]
    with pytest.raises(err):
        WRAPPERS[kind](tab, idx)


def test_vec_takes_a_table_above_shared_memory():
    """E2 stages nothing, so a table above the 227 KB a block can stage (the
    table E1 refuses) gathers like index_select."""
    t = G.SMEM_TABLE_MAX // 64 + 1
    tab, idx = _inputs(t, 16, 300, seed=5)
    t_tab, t_idx = torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)
    got = G.gather_vec(t_tab, t_idx)
    assert np.array_equal(got.numpy().view(np.uint32), tab[idx])
    assert torch.equal(got, t_tab.index_select(0, t_idx))
    with pytest.raises(ValueError):
        G.gather_smem_rows(t_tab, t_idx)


def test_async_ring_fits_shared_memory():
    """E3's ring keeps at least RING_BYTES of loads a warp (2 to 8 stages)
    and fits a block's shared memory: 4 warps of 32-row stages up to rows of
    224 words, then fewer warps, then fewer rows a stage, up to ASYNC_W_MAX
    words, which one warp of two one-row stages just fits."""
    plans = {w: G.async_plan(w)[:3] for w in (4, 16, 32, 64, 128, 224, 228, 908, 1024, 1812)}
    assert plans == {4: (4, 32, 8), 16: (4, 32, 8), 32: (4, 32, 5), 64: (4, 32, 3),
                     128: (4, 32, 2), 224: (4, 32, 2), 228: (2, 32, 2), 908: (1, 16, 2),
                     1024: (1, 16, 2), 1812: (1, 16, 2)}
    for w in range(4, G.ASYNC_W_MAX + 1, 4):
        warps, rows, depth, smem = G.async_plan(w)
        assert smem <= G.SMEM_TABLE_MAX and 2 <= depth <= G.RING_MAX
        assert depth == G.RING_MAX or (depth - 1) * rows * w * 4 >= G.RING_BYTES
    assert G.async_plan(G.ASYNC_W_MAX)[:3] == (1, 1, 2)
    assert G.async_plan(G.ASYNC_W_MAX + 4)[3] > G.SMEM_TABLE_MAX


@pytest.mark.parametrize("w", [16, 128])
@pytest.mark.parametrize("m", [31, 32, 33, 65])
def test_wrappers_on_partial_and_whole_stages(jax_harness, m, w):
    """E3's 32-row stages: a partial stage alone (31), one whole (32), one
    and a row (33), two and a row (65); a row repeated across the first
    stage boundary and the table's last row. All three wrappers through
    their checks and the CPU route, against E3's Pallas body and numpy."""
    tab, idx = _inputs(100, w, m, seed=100 * w + m)
    idx[31 % m] = idx[min(32, m - 1)] = 57  # repeated across rows 31 | 32
    idx[m // 2] = 99
    want = _jax_gather(jax_harness, "E3", tab, idx)
    assert np.array_equal(want, tab[idx])
    t_tab, t_idx = torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)
    for fn in WRAPPERS.values():
        got = fn(t_tab, t_idx)
        assert tuple(got.shape) == (m, w)
        assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("w", [228, 1024, 1812])
def test_wide_rows_take_a_smaller_ring(jax_harness, w):
    """Rows wider than 224 words, which E3 moves with fewer warps a block
    or fewer rows a stage: E2 and E3 through their checks and the CPU route
    equal E3's Pallas body, with a row repeated across a 16-row stage
    boundary and the table's last row."""
    tab, idx = _inputs(40, w, 33, seed=w)
    idx[15] = idx[16] = idx[31] = idx[32] = 39
    want = _jax_gather(jax_harness, "E3", tab, idx)
    assert np.array_equal(want, tab[idx])
    t_tab, t_idx = torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx)
    for fn in (G.gather_vec, G.gather_async):
        assert np.array_equal(fn(t_tab, t_idx).numpy().view(np.uint32), want)
