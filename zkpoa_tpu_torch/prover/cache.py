"""Proving-key cache: named keys reused across workflow runs.

Port of `zkpoa_tpu/prover/cache.py` (`cached_setup` :53, `_shape_digest`
:44), development setup only: the role of the reference's zkeys/
directory (full_workflow.sh:303-323,443-462). A key is cached under its
size-encoded name and a digest of the circuit shape and seed, as one file
`<name>.<digest>.pt` written by `torch.save`: the query tables as CPU
tensors and the small host fields (group points, verifying key) as one
JSON string. A cached key loads straight onto the requested device.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import torch

from ..models.r1cs import R1CS
from .setup import DeviceG1Points, DeviceG2Points, ProvingKey, setup_device

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
        cls = DeviceG2Points if name == "b2_query" else DeviceG1Points
        t = blob["tables"][name]
        kw[name] = cls(t["xs"], t["ys"], t["valid"])
    return ProvingKey(**kw, **meta)


def cached_setup(r1cs: R1CS, cache_dir: Optional[str], name: str, device,
                 seed: str = "zkpoa-test-srs") -> ProvingKey:
    """`setup_device` with an on-disk cache. `name` is the size-encoded key
    name of the reference, e.g. 'layer_two_full_2_sigs_12_height'."""
    if cache_dir is None:
        return setup_device(r1cs, device, seed=seed)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}.{_shape_digest(r1cs, seed)}.pt")
    if os.path.exists(path):
        return load_key(path, device)
    pk = setup_device(r1cs, device, seed=seed)
    save_key(path, pk)
    return pk
