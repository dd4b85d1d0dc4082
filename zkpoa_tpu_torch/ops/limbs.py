"""Exact multi-limb modular arithmetic on torch tensors (BN254 Fq and Fr).

Port of `zkpoa_tpu/ops/limbs.py`.

Representation: a field element is a tensor [..., 8] of dtype int32 whose
entries hold the bit patterns of eight little-endian 32-bit limbs. The CUDA
kernels read them as uint32. Montgomery form uses R = 2^256, the same R as
the JAX package's 16 x 16-bit layout, so a Montgomery value is the same
integer in both packages; only n0inv differs (mod 2^32 here).

Every public operation takes its route from where its tensors lie: on the
card it launches a kernel of `field_kernels` (B1), on the CPU it runs the
plain version below. The plain versions are ordinary torch code that also
runs on a CUDA tensor when called directly, which is how the kernels are
checked against them. Torch's uint32 supports only `*` and `&`, so the
plain versions compute in int64: additions keep 32-bit limbs and resolve
all carries at once with a carry-lookahead on bit masks; the Montgomery
product splits each limb into 16-bit halves so every partial product fits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from zkpoa_tpu.fields import bn254 as _bn254

from .. import host

N_LIMBS = 8
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF

_CONST_CACHE: Dict[Tuple, torch.Tensor] = {}


def _const(key, device, make) -> torch.Tensor:
    k = (key, str(device))
    t = _CONST_CACHE.get(k)
    if t is None:
        t = make().to(device)
        _CONST_CACHE[k] = t
    return t


def _int_to_u32(x: int) -> List[int]:
    return [(x >> (32 * j)) & MASK32 for j in range(N_LIMBS)]


def u32_to_i32(vals: Iterable[int]) -> List[int]:
    return [v - (1 << 32) if v >= (1 << 31) else v for v in vals]


@dataclass(frozen=True)
class FieldSpec:
    """Per-modulus constants; `kernel_id` names the modulus to the CUDA
    kernels (0 = Fq, 1 = Fr)."""

    modulus: int
    name: str
    kernel_id: int
    n0inv: int = field(init=False, repr=False, compare=False)
    r_mod: int = field(init=False, repr=False, compare=False)
    r2: int = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        assert self.modulus % 2 == 1 and self.modulus < (1 << 255)
        object.__setattr__(self, "n0inv", (-pow(self.modulus, -1, 1 << 32)) % (1 << 32))
        r = pow(2, 256, self.modulus)
        object.__setattr__(self, "r_mod", r)
        object.__setattr__(self, "r2", r * r % self.modulus)

    # ---- constants on a device ----

    def limbs_of(self, x: int, device) -> torch.Tensor:
        """One integer as an [8] int32 limb tensor on `device`."""
        return _const(
            ("v", self.modulus, x), device,
            lambda: torch.tensor(u32_to_i32(_int_to_u32(x)), dtype=torch.int32),
        )

    def mod_limbs(self, device) -> torch.Tensor:
        return self.limbs_of(self.modulus, device)

    def one_mont(self, device) -> torch.Tensor:
        return self.limbs_of(self.r_mod, device)

    # ---- host conversions ----

    def to_limbs(self, values) -> np.ndarray:
        """Python ints (a flat sequence) -> [N, 8] int32 plain limbs (mod p)."""
        return host.scalars_to_limbs_fast([int(v) % self.modulus for v in values])

    @staticmethod
    def from_limbs(limbs) -> List[int]:
        """[..., 8] limbs (tensor or array) -> flat list of Python ints."""
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.detach().cpu().numpy()
        return host.limbs_to_ints(limbs)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        return mont_mul(self, x, self.limbs_of(self.r2, x.device))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        return mont_mul(self, x, self.limbs_of(1, x.device))

    def encode(self, values, device) -> torch.Tensor:
        """ints -> [N, 8] Montgomery limbs on `device`."""
        return self.to_mont(torch.from_numpy(self.to_limbs(values)).to(device))

    def decode(self, limbs: torch.Tensor) -> List[int]:
        """Montgomery limbs -> flat list of Python ints."""
        return self.from_limbs(self.from_mont(limbs))


BN254_FQ = FieldSpec(_bn254.P, "bn254_fq", 0)
BN254_FR = FieldSpec(_bn254.R, "bn254_fr", 1)


# ---------------------------------------------------------------------------
# Plain versions (int64 inside; int32 limb tensors in and out)
# ---------------------------------------------------------------------------


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 limb tensor -> int64 tensor of the u32 values."""
    return x.to(torch.int64) & MASK32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 bit patterns."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _pow2(n: int, device) -> torch.Tensor:
    return _const(("pow2", n), device, lambda: torch.tensor([1 << i for i in range(n)], dtype=torch.int64))


def _lookahead(gen: torch.Tensor, prop: torch.Tensor):
    """Carries of a limb-wise sum at once. gen[i]: limb i emits a carry by
    itself; prop[i]: limb i passes an incoming carry on (disjoint masks).
    Returns (carry into each limb [..., n] int64, carry out [...])."""
    n = gen.shape[-1]
    w = _pow2(n, gen.device)
    g = (gen.to(torch.int64) * w).sum(-1)
    p = (prop.to(torch.int64) * w).sum(-1)
    c = ((g << 1) + p) ^ p
    cin = (c.unsqueeze(-1) // w) & 1
    return cin, (c >> n) & 1


def _add_raw(a: torch.Tensor, b: torch.Tensor):
    """u32 int64 limbs: a + b mod 2^256 and the carry out."""
    s = a + b
    lo = s & MASK32
    cin, cout = _lookahead(s > MASK32, lo == MASK32)
    return (lo + cin) & MASK32, cout


def _sub_raw(a: torch.Tensor, b: torch.Tensor):
    """u32 int64 limbs: a - b mod 2^256 and the borrow out."""
    d = a - b
    bin_, bout = _lookahead(d < 0, d == 0)
    return (d - bin_) & MASK32, bout


def _cond_sub(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x < 2p -> x mod p (u32 int64 limbs)."""
    d, borrow = _sub_raw(x, p)
    return torch.where((borrow == 0).unsqueeze(-1), d, x)


def _split16(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([v & MASK16, v >> 16], dim=-1).flatten(-2)


def _colsum(x16: torch.Tensor, y16: torch.Tensor) -> torch.Tensor:
    """Column sums of the 16 x 16 half-limb product: [..., 31], each < 2^36.
    Padding each row to 32 and re-reading the rows at width 31 shifts row i
    right by i, so one sum over the rows adds the anti-diagonals."""
    outer = x16.unsqueeze(-1) * y16.unsqueeze(-2)
    pad = torch.nn.functional.pad(outer, (0, 16)).flatten(-2)[..., :496]
    return pad.unflatten(-1, (16, 31)).sum(-2)


def _norm16(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Exact 16-bit normalisation of non-negative positions (< 2^(16 + 5
    passes)); the carry out of the top position is dropped."""
    for _ in range(passes):
        hi = t >> 16
        t = t & MASK16
        t[..., 1:] += hi[..., :-1]
    lo = t & MASK16
    cin, _ = _lookahead(t > MASK16, lo == MASK16)
    return (lo + cin) & MASK16


class Plain64:
    """The plain field versions on int64 tensors of u32 limb values (the
    form the plain point formulas keep between steps, converting only at
    their ends)."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.p = u32(spec.mod_limbs(device))
        self.p16 = _split16(self.p)
        np_ = (-pow(spec.modulus, -1, 1 << 256)) % (1 << 256)
        self.np16 = _const(("np16", spec.modulus), device, lambda: torch.tensor(
            [(np_ >> (16 * i)) & MASK16 for i in range(16)], dtype=torch.int64))
        self.one = u32(spec.one_mont(device))

    def add(self, a, b):
        s, _ = _add_raw(a, b)
        return _cond_sub(s, self.p)

    def sub(self, a, b):
        d, borrow = _sub_raw(a, b)
        dp, _ = _add_raw(d, self.p)
        return torch.where((borrow != 0).unsqueeze(-1), dp, d)

    def mul(self, a, b):
        """Montgomery product by whole-width REDC over 16-bit halves:
        T = a*b, m = (T mod 2^256)(-p^-1) mod 2^256, (T + m p) / 2^256 < 2p,
        then one conditional subtract."""
        t = _colsum(_split16(a), _split16(b))
        m = _norm16(_colsum(_norm16(t[..., :16], 3), self.np16)[..., :16], 3)
        u = torch.nn.functional.pad(t + _colsum(m, self.p16), (0, 2))
        u = _norm16(u, 3)[..., 16:32]  # low half is 0 mod 2^256; value < 2p
        return _cond_sub(u[..., 0::2] | (u[..., 1::2] << 16), self.p)


def plain64(spec: FieldSpec, device) -> Plain64:
    key = ("plain64", spec.modulus, str(device))
    obj = _CONST_CACHE.get(key)
    if obj is None:
        obj = Plain64(spec, device)
        _CONST_CACHE[key] = obj
    return obj


def add_mod_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to_i32(plain64(spec, a.device).add(u32(a), u32(b)))


def sub_mod_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to_i32(plain64(spec, a.device).sub(u32(a), u32(b)))


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to_i32(plain64(spec, a.device).mul(u32(a), u32(b)))


# ---------------------------------------------------------------------------
# Public operations: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        from . import field_kernels as FK

        return FK.field_binop(spec, FK.OP_MUL, a, b)
    return mont_mul_plain(spec, a, b)


def add_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        from . import field_kernels as FK

        return FK.field_binop(spec, FK.OP_ADD, a, b)
    return add_mod_plain(spec, a, b)


def sub_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda or b.is_cuda:
        from . import field_kernels as FK

        return FK.field_binop(spec, FK.OP_SUB, a, b)
    return sub_mod_plain(spec, a, b)


def neg_mod(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub_mod(spec, torch.zeros_like(a), a)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by Fermat (a^(p-2)), square-and-multiply over the
    public exponent bits: one batched product per step for the whole
    batch, no sequential prefix chain. 0 maps to 0."""
    e = spec.modulus - 2
    acc = a
    for i in range(e.bit_length() - 2, -1, -1):
        acc = mont_mul(spec, acc, acc)
        if (e >> i) & 1:
            acc = mont_mul(spec, acc, a)
    return acc


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, with cond shaped like the batch (no limb axis)."""
    return torch.where(cond.unsqueeze(-1), a, b)
