"""Launchers of the field and point kernels (csrc/field_ops.cu, point_ops.cu).

Port of `zkpoa_tpu/ops/pallas_field.py`: kernel B1 (the Montgomery product
with its add/sub helpers) and B2-B4 (mixed add, full add, double), for G1
and, unlike the TPU package, for G2 too; and of B8, fixed-base
multiplication (`zkpoa_tpu/ops/curve_jax.py:369`, csrc/fixed_base.cu).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current stream, raises if the
launch returned a CUDA error, and counts the launch in `_build.COUNTS`.
They take CUDA tensors only: the routing to the plain versions
(`limbs.*_plain`, `curve.jac_*`, `fp2` formulas) for CPU tensors lives in
the callers, `limbs.mont_mul`, the curve classes and
`curve.fixed_base_mul_batch`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .limbs import FieldSpec

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2
_OP_NAMES = {OP_MUL: "field_mont_mul", OP_ADD: "field_add_mod", OP_SUB: "field_sub_mod"}

G1, G2 = 1, 2
WIDTH = {G1: (8,), G2: (2, 8)}  # trailing shape of one coordinate


def _check(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: kernel input must be a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.shape[-1] != 8:
        raise ValueError(f"{name}: last dim must be 8 limbs, got {tuple(t.shape)}")


def field_binop(spec: FieldSpec, op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a*b*R^-1, a+b or a-b mod p over broadcast batches."""
    _check(a, "a")
    _check(b, "b")
    if spec.kernel_id not in (0, 1):
        raise ValueError(f"no kernel for field {spec.name}")
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(batch + (8,)).contiguous()
    # b repeats cyclically when its batch is a suffix of the output batch
    bb = list(b.shape[:-1])
    while bb and bb[0] == 1:
        bb.pop(0)
    if bb and tuple(bb) != tuple(batch[len(batch) - len(bb):]):
        b = b.expand(batch + (8,))
    b = b.contiguous()
    n = a.numel() // 8
    b_n = max(b.numel() // 8, 1)
    out = torch.empty(batch + (8,), dtype=torch.int32, device=a.device)
    _build.launch(
        "zk_field_binop", _OP_NAMES[op],
        spec.kernel_id, op, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, b_n,
    )
    return out


Jac = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _batch(group: int, t: torch.Tensor):
    return tuple(t.shape[: t.dim() - len(WIDTH[group])])


def _empty3(group: int, batch, device) -> Jac:
    shape = batch + WIDTH[group]
    return tuple(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(3))


def _numel(batch) -> int:
    n = 1
    for d in batch:
        n *= d
    return n


def _prep(group: int, coords, batch):
    want = batch + WIDTH[group]
    out = []
    for i, t in enumerate(coords):
        _check(t, f"coordinate {i}")
        if tuple(t.shape) != want:
            raise ValueError(f"coordinate {i}: shape {tuple(t.shape)}, expected {want}")
        out.append(t.contiguous())
    return out


def point_add(group: int, p: Jac, q: Jac) -> Jac:
    """Unified Jacobian add (kernel B3)."""
    batch = _batch(group, p[0])
    args = _prep(group, list(p) + list(q), batch)
    out = _empty3(group, batch, p[0].device)
    _build.launch(
        "zk_point_add", f"point_add_g{group}", group,
        *[t.data_ptr() for t in args], *[t.data_ptr() for t in out], _numel(batch),
    )
    return out


def point_add_affine(group: int, p: Jac, xq, yq, q_valid) -> Jac:
    """Unified mixed add of affine points with a validity mask (kernel B2)."""
    batch = _batch(group, p[0])
    args = _prep(group, list(p) + [xq, yq], batch)
    if not q_valid.is_cuda or q_valid.dtype != torch.bool or tuple(q_valid.shape) != batch:
        raise ValueError("q_valid: expected a CUDA bool tensor shaped like the batch")
    valid = q_valid.contiguous()
    out = _empty3(group, batch, p[0].device)
    _build.launch(
        "zk_point_add_affine", f"point_add_affine_g{group}", group,
        *[t.data_ptr() for t in args], valid.data_ptr(),
        *[t.data_ptr() for t in out], _numel(batch),
    )
    return out


def point_double(group: int, p: Jac) -> Jac:
    """Jacobian doubling, a = 0 (kernel B4)."""
    batch = _batch(group, p[0])
    args = _prep(group, list(p), batch)
    out = _empty3(group, batch, p[0].device)
    _build.launch(
        "zk_point_double", f"point_double_g{group}", group,
        *[t.data_ptr() for t in args], *[t.data_ptr() for t in out], _numel(batch),
    )
    return out


def fixed_base(group: int, xs_t, ys_t, valid_t, scalars: torch.Tensor, nwin: int) -> Jac:
    """k_i * base for plain-limb scalars [N, 8], folding the first `nwin`
    rows of a fixed-base table (xs_t, ys_t [rows, 256, *coord], valid_t
    [rows, 256]) in one launch (kernel B8)."""
    _check(scalars, "scalars")
    if scalars.dim() != 2:
        raise ValueError(f"scalars: expected [N, 8], got {tuple(scalars.shape)}")
    rows = xs_t.shape[0]
    if not 0 < nwin <= min(rows, 32):
        raise ValueError(f"nwin {nwin} outside 1..{min(rows, 32)}")
    table = _prep(group, [xs_t, ys_t], (rows, 256))
    if (not valid_t.is_cuda or valid_t.dtype != torch.bool
            or tuple(valid_t.shape) != (rows, 256) or not valid_t.is_contiguous()):
        raise ValueError("valid_t: expected a contiguous CUDA bool tensor [rows, 256]")
    if xs_t.device != scalars.device:
        raise ValueError("scalars and table must lie on one device")
    sc = scalars.contiguous()
    n = sc.shape[0]
    out = _empty3(group, (n,), sc.device)
    _build.launch(
        "zk_fixed_base", f"fixed_base_g{group}", group,
        table[0].data_ptr(), table[1].data_ptr(), valid_t.data_ptr(), sc.data_ptr(), nwin, n,
        *[t.data_ptr() for t in out],
    )
    return out
