"""Proving-key cache: named keys reused across workflow runs.

Port of `zkpoa_tpu/prover/cache.py` (`cached_setup` :53, `_shape_digest`
:44, `_ptau_digest` :104, `_cached_setup_ptau` :115): the role of the
reference's zkeys/ directory (full_workflow.sh:303-323,443-462). A key is
cached under its size-encoded name and a digest of the circuit shape and
seed, as one file `<name>.<digest>.pt` written by `torch.save`: the query
tables as CPU tensors and the small host fields (group points, verifying
key) as one JSON string. A cached key loads straight onto the requested
device. A key from a powers-of-tau ceremony (`ptau_path`) is cached the
same way as `<name>.ptau.<digest>.pt`, its digest over the circuit shape,
the ceremony file's digest and the phase-2 parameters.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, List, Optional

import torch

from ..models.r1cs import R1CS
from ..ops.curve import BN254_G1
from ..ops.fp2 import BN254_G2
from .setup import ProvingKey, setup_device

_TABLES = ("a_query", "b1_query", "c_query", "h_query", "b2_query")
_HOST_FIELDS = ("n_vars", "n_public", "domain_size", "alpha1", "beta1", "delta1",
                "beta2", "delta2", "vk_json", "h_basis")


def _shape_digest(r1cs: R1CS, seed: str) -> str:
    h = hashlib.sha256()
    h.update(f"{r1cs.n_wires}|{r1cs.n_public}|{r1cs.n_constraints}|{seed}".encode())
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        h.update(str(len(rows)).encode())
        # sample rows for a cheap structural fingerprint
        step = max(1, len(rows) // 1024)
        for t in rows[::step]:
            h.update(repr(t).encode())
    return h.hexdigest()[:16]


def _tuples(x):
    """JSON lists back to the nested tuples the group points are."""
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def save_key(path: str, pk: ProvingKey) -> None:
    tables = {}
    for name in _TABLES:
        q = getattr(pk, name)
        tables[name] = {"xs": q.xs.cpu(), "ys": q.ys.cpu(), "valid": q.valid.cpu()}
    meta = json.dumps({k: getattr(pk, k) for k in _HOST_FIELDS})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"tables": tables, "meta": meta}, tmp)
    os.replace(tmp, path)


def load_key(path: str, device) -> ProvingKey:
    blob = torch.load(path, map_location=device, weights_only=True)
    meta = json.loads(blob["meta"])
    for k in ("alpha1", "beta1", "delta1", "beta2", "delta2"):
        meta[k] = _tuples(meta[k])
    kw = {}
    for name in _TABLES:
        curve = BN254_G2 if name == "b2_query" else BN254_G1
        t = blob["tables"][name]
        kw[name] = curve.table(t["xs"], t["ys"], t["valid"])
    return ProvingKey(**kw, **meta)


def cached_setup(r1cs: R1CS, cache_dir: Optional[str], name: str, device,
                 seed: str = "zkpoa-test-srs", hits: Optional[List[str]] = None,
                 ptau_path: Optional[str] = None, contribute_entropy: Optional[str] = None,
                 beacon_hash: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None, save: bool = True) -> ProvingKey:
    """`setup_device` with an on-disk cache. `name` is the size-encoded key
    name of the reference, e.g. 'layer_two_full_2_sigs_12_height'; a key
    loaded from the cache appends its name to `hits`. With `save` False
    the cache is only read: a key made here is not written (the ranks
    above 0 of a multi-process workflow, which share rank 0's cache).

    With `ptau_path`, the key derives from the powers-of-tau ceremony file
    instead of the seeded dev setup, the reference's production path
    (`snarkjs zkey new` + contribute + beacon, g16_setup.sh:240-278); a
    key made here logs its setup's split by part through `log`."""
    if ptau_path is not None:
        return _cached_setup_ptau(r1cs, cache_dir, name, device, ptau_path, contribute_entropy,
                                  beacon_hash, hits, log, save)
    if cache_dir is None:
        return setup_device(r1cs, device, seed=seed)
    path = os.path.join(cache_dir, f"{name}.{_shape_digest(r1cs, seed)}.pt")
    if os.path.exists(path):
        if hits is not None:
            hits.append(name)
        return load_key(path, device)
    pk = setup_device(r1cs, device, seed=seed)
    if save:
        save_key(path, pk)
    return pk


def _ptau_digest(ptau_path: str) -> str:
    h = hashlib.sha256()
    with open(ptau_path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()[:16]


def _cached_setup_ptau(r1cs: R1CS, cache_dir: Optional[str], name: str, device, ptau_path: str,
                       contribute_entropy: Optional[str], beacon_hash: Optional[str],
                       hits: Optional[List[str]], log, save: bool = True) -> ProvingKey:
    """Ceremony-derived key: phase 1 from the .ptau file, then the
    optional phase-2 contribution and beacon (reference
    g16_setup.sh:255-278), cached as a key file keyed on (circuit shape,
    ptau digest, phase-2 parameters)."""
    from . import ptau as P

    def build() -> ProvingKey:
        times = {}
        pk = P.setup_from_ptau(r1cs, ptau_path, device, times=times)
        if contribute_entropy is not None:
            with P._timed(times, "contribute", device):
                pk = P.contribute(pk, contribute_entropy)
        if beacon_hash is not None:
            with P._timed(times, "beacon", device):
                pk = P.beacon(pk, beacon_hash)
        if log is not None:
            log(P.setup_split(times))
        return pk

    if cache_dir is None:
        return build()
    tag = f"{_ptau_digest(ptau_path)}|{contribute_entropy}|{beacon_hash}"
    path = os.path.join(cache_dir, f"{name}.ptau.{_shape_digest(r1cs, tag)}.pt")
    if os.path.exists(path):
        if hits is not None:
            hits.append(name)
        return load_key(path, device)
    pk = build()
    if save:
        save_key(path, pk)
    return pk
