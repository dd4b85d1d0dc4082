"""Row gathers out[i, :] = tab[idx[i], :] (kernels E1-E3, csrc/gather.cu).

Port of the three Pallas gather kernels of the JAX package's MSM stage
harness, `experiments/msm_stages.py`: E1 `vmem_gather` (:89, a table
resident in VMEM read row by row), E2 `vmem_take` (:109, the same as one
vectorised take) and E3 `dma_gather` (:148, one DMA per row through an
8-deep ring). They run in the port's harness,
`zkpoa_tpu_torch/experiments/msm_stages.py`, which races them against
`torch.index_select`.

The designs are the card's, not the TPU's (`csrc/gather.cu` has the
details): E1 and E2 stage nothing and read rows through the read-only
cache, where a small table stays resident; E1 takes rows of any width, a
warp's lanes across the pieces of its contiguous output rows (16 bytes
where the width and alignment allow, else 4), E2 rows of whole 16-byte
pieces; E3 moves stages of up to 32 rows with TMA bulk copies into a
shared-memory ring per warp and writes each stage back with one bulk
store.

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

# Dynamic shared memory a block may opt into on sm_90 (227 KB): the most
# E3's ring may take. Its launcher also checks the card's own value.
SMEM_OPTIN_MAX = 232_448
ASYNC_WARPS = 4  # E3 most warps per block, each with its own ring
STAGE_ROWS = 32  # E3 most rows a stage
RING_BYTES = 16_384  # E3 bytes of loads a warp keeps in flight, at least
RING_MAX = 8  # E3 most stages a ring


def async_plan(w: int) -> tuple[int, int, int, int]:
    """E3's (warps a block, rows a stage, ring depth, shared memory a block)
    for rows of w words (csrc/gather.cu `async_plan`): 4 warps and 32-row
    stages while a ring of them fits, else fewer warps, then fewer rows."""
    warps, rows = ASYNC_WARPS, STAGE_ROWS
    while True:
        stage = rows * w * 4
        depth = max(2, min(RING_MAX, -(-RING_BYTES // stage) + 1))
        smem = (warps * depth + 1) // 2 * 16 + warps * depth * stage
        if smem <= SMEM_OPTIN_MAX or (warps, rows) == (1, 1):
            return warps, rows, depth, smem
        if warps > 1:
            warps //= 2
        else:
            rows //= 2


# the widest rows E3 takes: one warp a block with a ring of two one-row stages
ASYNC_W_MAX = (SMEM_OPTIN_MAX - 16) // 8 // 4 * 4


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of E1-E3."""
    return tab.index_select(0, idx)


def _check(kind: str, tab: torch.Tensor, idx: torch.Tensor):
    """Raises on what the kernel cannot take; returns (T, W, M)."""
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
    if kind in ("gather_vec", "gather_async") and w % 4 != 0:
        raise ValueError(f"{kind}: rows of {w} words are not a whole number of 16-byte lanes")
    if kind == "gather_async" and async_plan(w)[3] > SMEM_OPTIN_MAX:
        raise ValueError(f"{kind}: rows of {w} words do not fit its shared-memory ring")
    return t, w, idx.shape[0]


def _gather(kind: str, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    t, w, m = _check(kind, tab, idx)
    if not tab.is_cuda:
        return gather_rows_plain(tab, idx)
    out = tab.new_empty((m, w))
    if m == 0:
        return out
    ptr = tab.data_ptr()
    if kind != "gather_rows" and ptr % 16:
        raise ValueError(f"{kind}: the table must be 16-byte aligned for 16-byte loads")
    _build.launch(f"zk_{kind}", kind, ptr, idx.data_ptr(), t, w, m, out.data_ptr())
    return out


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E1: rows of any width from a table of any size, nothing staged; a
    warp moves contiguous output rows, its lanes across their 16-byte
    pieces where the width and both pointers allow, else their words
    (replaces `vmem_gather`, experiments/msm_stages.py:91)."""
    return _gather("gather_rows", tab, idx)


def gather_vec(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E2: a vector gather from the cache-resident table, 16 bytes a lane,
    four loads in flight a lane, no staging; any table size (replaces
    `vmem_take`, experiments/msm_stages.py:110)."""
    return _gather("gather_vec", tab, idx)


def gather_async(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """E3: stages of up to 32 rows moved by TMA bulk copies through a ring
    per warp, each stage written back by one bulk store; rows of up to
    ASYNC_W_MAX words (replaces `dma_gather`, experiments/msm_stages.py:150)."""
    return _gather("gather_async", tab, idx)
