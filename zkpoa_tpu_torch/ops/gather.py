"""Row gathers out[i, :] = tab[idx[i], :] (kernels E1-E3, csrc/gather.cu).

Port of the three Pallas gather kernels of the JAX package's MSM stage
harness, `experiments/msm_stages.py`: E1 `vmem_gather` (:89, a table
resident in VMEM read row by row), E2 `vmem_take` (:109, the same as one
vectorised take) and E3 `dma_gather` (:148, one DMA per row through an
8-deep ring). They run in the port's harness,
`zkpoa_tpu_torch/experiments/msm_stages.py`, which races them against
`torch.index_select`.

Tables are [T, W] int32 (the port's limb type; the kernels move the bits
as u32) and indices [M] int32. Each wrapper checks device, dtype, shape,
contiguity and its kernel's own limits on any device; then a CPU tensor
takes the plain version, `gather_rows_plain`, and a CUDA tensor launches
the kernel, counted in `_build.COUNTS`, or raises. M == 0 returns an empty
[0, W] tensor without a launch. No wrapper falls back to `index_select`
on the card.
"""

from __future__ import annotations

import torch

from .. import _build

# Dynamic shared memory a block may opt into on sm_90 (227 KB): the largest
# table E1 and E2 can stage. The launcher also checks the card's own value.
SMEM_TABLE_MAX = 232_448
RING = 8  # E3 ring stages per warp
ASYNC_WARPS = 4  # E3 warps per block


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of E1-E3."""
    return tab.index_select(0, idx)


def _check(kind: str, tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"{kind}: expected int32 tab and idx, got {tab.dtype} and {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{kind}: expected tab [T, W] and idx [M], got {tuple(tab.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{kind}: tab and idx must be contiguous")
    if tab.device != idx.device:
        raise ValueError(f"{kind}: tab and idx must lie on one device")
    t, w = tab.shape
    if w == 0 or (t == 0 and idx.shape[0] > 0):
        raise ValueError(f"{kind}: empty table {tuple(tab.shape)}")
    if kind in ("gather_smem_rows", "gather_smem_vec") and t * w * 4 > SMEM_TABLE_MAX:
        raise ValueError(f"{kind}: table of {t * w * 4} bytes exceeds the {SMEM_TABLE_MAX} bytes "
                         f"of shared memory a block can hold")
    if kind in ("gather_smem_vec", "gather_async") and w % 4 != 0:
        raise ValueError(f"{kind}: rows of {w} words are not a whole number of 16-byte lanes")
    if kind == "gather_async" and ASYNC_WARPS * RING * (8 + 4 * w) > SMEM_TABLE_MAX:
        raise ValueError(f"{kind}: rows of {w} words do not fit its shared-memory ring")


def _gather(kind: str, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(kind, tab, idx)
    if not tab.is_cuda:
        return gather_rows_plain(tab, idx)
    m = idx.shape[0]
    out = torch.empty((m, tab.shape[1]), dtype=torch.int32, device=tab.device)
    if m == 0:
        return out
    if kind == "gather_async" and tab.data_ptr() % 16:
        raise ValueError(f"{kind}: the table must be 16-byte aligned for bulk copies")
    _build.launch(f"zk_{kind}", kind, tab.data_ptr(), idx.data_ptr(), tab.shape[0],
                  tab.shape[1], m, out.data_ptr())
    return out


def gather_smem_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E1: the table staged in each block's shared memory, one thread per
    output row (replaces `vmem_gather`, experiments/msm_stages.py:91)."""
    return _gather("gather_smem_rows", tab, idx)


def gather_smem_vec(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E2: the staged table, rows written by 16-byte lanes, a warp's 512
    bytes at a time (replaces `vmem_take`, experiments/msm_stages.py:110)."""
    return _gather("gather_smem_vec", tab, idx)


def gather_async(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E3: per-row TMA bulk copies through an 8-stage ring of each warp
    (replaces `dma_gather`, experiments/msm_stages.py:150)."""
    return _gather("gather_async", tab, idx)
