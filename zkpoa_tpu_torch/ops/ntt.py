"""Radix-2 NTT over the BN254 scalar field, and the Groth16 quotient h(X).

Port of `zkpoa_tpu/ops/ntt.py` (`ntt` :94, `coset_qap_evals` :145,
`quotient` :173) for both H bases. One path at every size: the JAX
package's blocked four-step variant (`ops/ntt_blocked.py`) exists to fit
TPU HBM; at a 2^21 domain the three operands here are ~200 MB.

Values are Montgomery limb tensors [..., n, 8]: the transform runs over
axis -2 and leading axes are a batch of independent transforms, as in the
JAX package (`prove_batched` stacks its operands, the four-step NTT
transforms the rows and columns of a matrix). On the card a transform is
ceil(log_n / TILE_LOG) launches of one stage-blocked pass kernel
(csrc/ntt.cu): each pass runs up to TILE_LOG butterfly stages on a tile in
shared memory, the first reads through the bit reversal, the last
multiplies by a scale; a batch runs in the same launches, the grid's
second dimension over its transforms, which share the twiddle table and
the scale. The quotient folds its constant factors into those
scales: an inverse transform's 1/n, the coset powers g^i after the three
inverse transforms, and g^-i with 1/n and 1/Z(g) after the last one. On the
CPU the same schedule runs in plain torch (`ntt_passes_plain`); `ntt_plain`
is the per-stage loop the schedule replaced, kept as the reference. The
twiddles of every stage index one table of powers of the domain root,
built on the device by a masked binary power ladder.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import _build
from ..fields.bn254 import FR_GENERATOR, R
from ..host import domain_root, snarkjs_coset_shift
from . import limbs as L
from .limbs import BN254_FR

MAX_TILE_LOG = 11  # csrc/ntt.cu NTT_MAX_TILE_LOG: a tile of 2^11 elements is 64 KB of shared memory
TILE_LOG = MAX_TILE_LOG  # the main path's tiles: a 2^21 transform in two passes
MAX_LOG_N = 28  # Fr's 2-adicity

_TABLES: Dict[Tuple, torch.Tensor] = {}


def pow_table(base: int, count: int, device, scale: int = 1) -> torch.Tensor:
    """[scale * base^i for i < count] as Montgomery limbs on the device:
    2 * log2(count) batched products, no sequential power chain (port of
    `prover/setup.py:279` `_dev_pow_table`)."""
    spec = BN254_FR
    bits = max((count - 1).bit_length(), 1)
    idx = torch.arange(count, device=device, dtype=torch.int64)
    t = spec.encode([scale % R], device).expand(count, 8).contiguous()
    s = spec.encode([base % R], device)
    for b in range(bits):
        bit = ((idx >> b) & 1).bool()
        t = L.select(bit, L.mont_mul(spec, t, s), t)
        if b + 1 < bits:
            s = L.mont_mul(spec, s, s)
    return t


def _cached(key, make) -> torch.Tensor:
    t = _TABLES.get(key)
    if t is None:
        t = make()
        _TABLES[key] = t
    return t


def _bitrev(log_n: int, device) -> torch.Tensor:
    def make():
        i = torch.arange(1 << log_n, device=device, dtype=torch.int64)
        rev = torch.zeros_like(i)
        for b in range(log_n):
            rev |= ((i >> b) & 1) << (log_n - 1 - b)
        return rev
    return _cached(("rev", log_n, str(device)), make)


def _twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """w^k for k < n/2, w the domain root (or its inverse)."""
    def make():
        w = domain_root(log_n)
        return pow_table(pow(w, -1, R) if inverse else w, (1 << log_n) // 2, device)
    return _cached(("tw", log_n, inverse, str(device)), make)


def _log_size(values: torch.Tensor) -> int:
    n = values.shape[-2]
    log_n = n.bit_length() - 1
    if n == 0 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if log_n > MAX_LOG_N:
        raise ValueError(f"NTT size 2^{log_n} exceeds Fr's 2-adicity {MAX_LOG_N}")
    return log_n


def ntt_passes(log_n: int, tile_log: int) -> List[Tuple[int, int, int]]:
    """The pass schedule of a 2^log_n transform in tiles of 2^tile_log:
    (s0, w, log_c) per pass, which runs stages s0 .. s0 + w - 1 on groups
    of 2^w elements at stride 2^s0, 2^log_c consecutive groups a tile."""
    if not 1 <= tile_log <= MAX_TILE_LOG:
        raise ValueError(f"tile_log must lie in 1..{MAX_TILE_LOG}, got {tile_log}")
    out, s0 = [], 0
    while True:
        w = min(tile_log, log_n - s0)
        out.append((s0, w, min(tile_log - w, s0)))
        s0 += w
        if s0 >= log_n:
            return out


def _scale_mode(scale: Optional[torch.Tensor], n: int) -> int:
    """0: no scale; 1: one constant [8] or [1, 8]; 2: a table [n, 8]."""
    if scale is None:
        return 0
    if scale.shape[-1] != 8 or scale.dim() > 2:
        raise ValueError(f"scale: expected [8], [1, 8] or [n, 8] limbs, got {tuple(scale.shape)}")
    if scale.numel() == 8:
        return 1
    if tuple(scale.shape) != (n, 8):
        raise ValueError(f"scale: expected [{n}, 8], got {tuple(scale.shape)}")
    return 2


def _apply_scale_plain(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    mode = _scale_mode(scale, x.shape[-2])
    if mode == 0:
        return x
    return L.mont_mul_plain(BN254_FR, x, scale.reshape(1, 8) if mode == 1 else scale)


def ntt_plain(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The per-stage transform of plain ops (the route the pass kernel
    replaced; the reference): bit-reversal gather, then per stage one
    product of the odd half by the stage twiddles and an add/sub pair."""
    spec = BN254_FR
    log_n = _log_size(values)
    n, device, lead = 1 << log_n, values.device, values.shape[:-2]
    x = values[..., _bitrev(log_n, device), :]
    if log_n:
        big = _twiddles(log_n, inverse, device)
        for s in range(log_n):
            half = 1 << s
            tw = big[:: n // (2 * half)]  # w^(j n / 2h), j < h
            xb = x.reshape(lead + (n // (2 * half), 2, half, 8))
            u = xb[..., 0, :, :]
            v = L.mont_mul_plain(spec, xb[..., 1, :, :], tw)
            x = torch.stack([L.add_mod_plain(spec, u, v), L.sub_mod_plain(spec, u, v)],
                            dim=-3).reshape(lead + (n, 8))
    if inverse:
        x = L.mont_mul_plain(spec, x, spec.encode([pow(n, -1, R)], device))
    return x


def ntt_passes_plain(values: torch.Tensor, inverse: bool = False,
                     scale: Optional[torch.Tensor] = None,
                     tile_log: Optional[int] = None) -> torch.Tensor:
    """The pass kernel's schedule in plain torch, every block of a pass at
    once: the same tile indices, butterfly pairs and twiddle indices as
    csrc/ntt.cu, the scale applied in the last pass, every transform of
    a batch [..., n, 8] alike. No 1/n: an inverse transform's scale
    carries it."""
    spec = BN254_FR
    log_n = _log_size(values)
    n, device = 1 << log_n, values.device
    big = _twiddles(log_n, inverse, device)
    passes = ntt_passes(log_n, TILE_LOG if tile_log is None else tile_log)
    ar = lambda m: torch.arange(m, device=device, dtype=torch.int64)  # noqa: E731
    x = values.reshape(-1, n, 8)
    for p, (s0, w, log_c) in enumerate(passes):
        tile, cmask = 1 << (w + log_c), (1 << log_c) - 1
        blk = ar(n >> (w + log_c))[:, None]
        lb_bits = s0 - log_c
        l0 = (blk & ((1 << lb_bits) - 1)) << log_c
        base = ((blk >> lb_bits) << (s0 + w)) | l0
        k = ar(tile)[None, :]
        i = base | ((k >> log_c) << s0) | (k & cmask)  # [blocks, tile]
        t = x[:, _bitrev(log_n, device)[i] if p == 0 else i]  # [batch, blocks, tile, 8]
        for r in range(w):
            s, rmask = s0 + r, (1 << r) - 1
            q = ar(tile >> 1)
            c, bq = q & cmask, q >> log_c
            k_lo = ((((bq >> r) << (r + 1)) | (bq & rmask)) << log_c) | c
            k_hi = k_lo + (1 << (r + log_c))
            j = ((bq & rmask) << s0)[None, :] | l0 | c[None, :]  # i mod 2^s
            u = t[:, :, k_lo]
            v = L.mont_mul_plain(spec, t[:, :, k_hi], big[j << (log_n - 1 - s)])
            t[:, :, k_lo] = L.add_mod_plain(spec, u, v)
            t[:, :, k_hi] = L.sub_mod_plain(spec, u, v)
        y = torch.empty_like(x)
        y[:, i.reshape(-1)] = t.reshape(x.shape[0], -1, 8)
        x = y
    return _apply_scale_plain(x.reshape(values.shape), scale)


def ntt_kernel(values: torch.Tensor, inverse: bool = False,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transform by the pass kernel (csrc/ntt.cu) in tiles of
    2^TILE_LOG, one launch a pass for every transform of the batch
    [..., n, 8], the scale folded into the last; CUDA tensors only."""
    if values.dtype != torch.int32:
        raise TypeError(f"ntt_kernel: expected int32 limbs, got {values.dtype}")
    if values.dim() < 2 or values.shape[-1] != 8 or not values.is_contiguous():
        raise ValueError(f"ntt_kernel: expected contiguous [..., n, 8] limbs, got "
                         f"{tuple(values.shape)}")
    log_n = _log_size(values)
    n = 1 << log_n
    batch = values.numel() // (8 * n)
    mode = _scale_mode(scale, n)
    if not values.is_cuda:
        raise ValueError("ntt_kernel: values must be a CUDA tensor")
    if mode and (scale.device != values.device or scale.dtype != torch.int32
                 or not scale.is_contiguous()):
        raise ValueError("ntt_kernel: scale must be contiguous int32 limbs on the values' device")
    passes = ntt_passes(log_n, TILE_LOG)
    big = _twiddles(log_n, inverse, values.device)
    out = torch.empty_like(values)
    if batch == 0:
        return out
    for p, (s0, w, log_c) in enumerate(passes):
        last = p == len(passes) - 1
        _build.launch(
            "zk_ntt_pass", "ntt_pass",
            values.data_ptr() if p == 0 else out.data_ptr(), out.data_ptr(), big.data_ptr(),
            scale.data_ptr() if mode else 0, log_n, s0, w, log_c, int(p == 0),
            mode if last else 0, batch, n,
        )
    return out


def _transform(values: torch.Tensor, inverse: bool,
               scale: Optional[torch.Tensor]) -> torch.Tensor:
    if values.is_cuda:
        return ntt_kernel(values, inverse, scale)
    return ntt_passes_plain(values, inverse, scale)


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Transform of Montgomery limbs [..., n, 8] over axis -2, n a power
    of two, leading axes a batch (an inverse transform's 1/n folded into
    its last pass)."""
    if not inverse:
        return _transform(values, False, None)
    n, device = values.shape[-2], values.device
    ninv = _cached(("ninv", n, str(device)), lambda: BN254_FR.encode([pow(n, -1, R)], device))
    return _transform(values, True, ninv)


def coset_qap_evals(a_ev, b_ev, c_ev, shift: int = None) -> torch.Tensor:
    """(A*B - C) evaluated over the coset shift*D: the h-MSM operand for
    keys in snarkjs' coset-Lagrange basis (port of `ntt.py:145`). Each
    operand: an inverse transform whose last pass multiplies element i by
    shift^i / n, then a forward transform. Operands [..., n, 8], leading
    axes a batch."""
    n = a_ev.shape[-2]
    if shift is None:
        shift = snarkjs_coset_shift(n.bit_length() - 1)
    spec = BN254_FR
    device = a_ev.device
    ninv = pow(n, -1, R)
    tab = _cached(("coset", n, shift, ninv, str(device)),
                  lambda: pow_table(shift, n, device, scale=ninv))
    a_s, b_s, c_s = (_transform(_transform(v, True, tab), False, None)
                     for v in (a_ev, b_ev, c_ev))
    return L.sub_mod(spec, L.mont_mul(spec, a_s, b_s), c_s)


def quotient(a_ev, b_ev, c_ev) -> torch.Tensor:
    """h(X) coefficients [..., n, 8] (Montgomery) with (A*B - C) = h * Z on the
    domain, Z = X^n - 1 (port of `ntt.py:173`): the coset evaluations, then
    one inverse transform whose last pass multiplies element i by
    g^-i / (n Z(g)), Z(g) = g^n - 1."""
    n = a_ev.shape[-2]
    device = a_ev.device
    num = coset_qap_evals(a_ev, b_ev, c_ev, shift=FR_GENERATOR)
    zinv = pow((pow(FR_GENERATOR, n, R) - 1) % R, -1, R)
    factor = zinv * pow(n, -1, R) % R
    back = _cached(("uncoset", n, factor, str(device)),
                   lambda: pow_table(pow(FR_GENERATOR, -1, R), n, device, scale=factor))
    return _transform(num, True, back)
