"""Framework-neutral host helpers, copied out of JAX modules.

Each function below but the port's own `witness_limbs` is a copy of a
helper that lives inside a module of the JAX package that imports `jax` at
load time; the port cannot import those modules, so it carries its own
copies. Each copy names its original. Seeds and byte layouts are kept
identical so that keys and proofs made by the port equal the JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

from . import _build
from .fields.bn254 import FR_GENERATOR, R, TWO_ADICITY

LIMB_BITS = 32
N_LIMBS = 8  # 8 x 32-bit limbs per 256-bit field element


def scalars_to_limbs_fast(scalars, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Host ints -> [N, 8] int32 arrays holding little-endian u32 limbs.

    Copy of `zkpoa_tpu/ops/msm_pallas.py:2352` `scalars_to_limbs_fast`,
    re-cut for the port's 8 x 32-bit layout (the int32 holds the u32 bit
    pattern)."""
    blob = b"".join(int(s).to_bytes(4 * n_limbs, "little") for s in scalars)
    arr = np.frombuffer(blob, dtype="<u4").reshape(len(scalars), n_limbs)
    return arr.view(np.int32).copy()


def witness_limbs(witness: Sequence[int]) -> Tuple[np.ndarray, int]:
    """The values `int(x) % R` of a witness as plain limbs [n, 8] int32 (the
    u32 bit pattern), equal to `scalars_to_limbs_fast([int(x) % R for x in
    witness])` for every input, and the number of values that took the
    Python fallback. One native pass (`csrc/witness_limbs.c`) converts each
    exact int in [0, R); every other item is converted here, by the rule
    above, and put in its row."""
    n = len(witness)
    limbs = np.empty((n, N_LIMBS), dtype=np.int32)
    miss = np.empty(n, dtype=np.int64)
    n_miss = _build.host_lib().zk_witness_limbs(witness, n, limbs.ctypes.data,
                                                miss.ctypes.data)
    if n_miss:
        rows = miss[:n_miss]
        limbs[rows] = scalars_to_limbs_fast([int(witness[i]) % R for i in rows.tolist()])
    return limbs, n_miss


def limbs_to_ints(limbs) -> List[int]:
    """[..., 8] int32/uint32 limb array -> flat list of Python ints."""
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u4"))
    blob = arr.reshape(-1, N_LIMBS).tobytes()
    return [int.from_bytes(blob[i : i + 32], "little") for i in range(0, len(blob), 32)]


def domain_root(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in Fr.

    Copy of `zkpoa_tpu/ops/ntt.py:34` `domain_root`."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"domain 2^{log_n} exceeds 2-adicity {TWO_ADICITY}")
    return pow(FR_GENERATOR, (R - 1) >> log_n, R)


def snarkjs_coset_shift(log_n: int) -> int:
    """The coset shift snarkjs/rapidsnark use for the h-query of a 2^log_n
    domain: the primitive 2n-th root of unity (shift^n = -1).

    Copy of `zkpoa_tpu/ops/ntt.py:110` `snarkjs_coset_shift`."""
    return domain_root(log_n + 1)


def _rand_fr(seed: str, label: str) -> int:
    """Proof randomness (r, s) from a seed.

    Copy of `zkpoa_tpu/prover/prove.py:34` `_rand_fr`."""
    h = hashlib.sha256(f"zkpoa-prove|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R


def _hash_to_fr(seed: str, label: str) -> int:
    """Development-setup trapdoors (tau, alpha, ...) from a seed.

    Copy of `zkpoa_tpu/prover/setup.py:34` `_hash_to_fr`."""
    h = hashlib.sha256(f"zkpoa-srs|{seed}|{label}".encode()).digest()
    h += hashlib.sha256(h).digest()
    return int.from_bytes(h, "big") % R
