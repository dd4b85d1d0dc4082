"""Keccak-256 of the port (`zkpoa_tpu_torch/ops/keccak.py`) on the CPU,
against the JAX package's `zkpoa_tpu/ops/keccak.py`: the host half's known
vectors and multi-block messages; the batch half (plain torch, each 64-bit
lane as two 32-bit halves held in int64) with `keccak_f_batch` on random
states, `keccak256_fixed_batch` at message lengths 0, 1, 64 and 135 (one
block's edge) against the JAX batch and the host, and `eth_addresses_batch`
on secp256k1 public keys; the golden anonymity set of the reference's
fixtures where they are mounted. Inputs are numpy-seeded; all exact."""

import csv
import re

import numpy as np
import pytest
import torch

import tests.conftest as cft
from zkpoa_tpu.ops import keccak as JK
from zkpoa_tpu_torch.fields import secp256k1
from zkpoa_tpu_torch.ops import keccak as K

torch.set_num_threads(1)

KECCAK_EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
KECCAK_ABC = "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


def test_host_known_vectors():
    assert K.keccak256(b"").hex() == KECCAK_EMPTY
    assert K.keccak256(b"abc").hex() == KECCAK_ABC


@pytest.mark.parametrize("length", [135, 136, 137, 300])
def test_host_multiblock_matches_jax(length):
    rng = np.random.default_rng(length)
    msg = rng.bytes(length)
    assert K.keccak256(msg) == JK.keccak256(msg)
    assert K.keccak256(msg) != K.keccak256(msg[:-1] + bytes([msg[-1] ^ 1]))


def test_keccak_f_batch_matches_jax():
    rng = np.random.default_rng(7)
    state = rng.integers(0, 1 << 32, size=(16, 5, 5, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JK.keccak_f_batch(state))
    got = K.keccak_f_batch(torch.from_numpy(state.astype(np.int64)))
    assert got.dtype == torch.int64 and tuple(got.shape) == (16, 5, 5, 2)
    assert (got.numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize("length", [0, 1, 64, 135])
def test_fixed_batch_matches_jax_and_host(length):
    rng = np.random.default_rng(100 + length)
    msgs = rng.integers(0, 256, size=(6, length), dtype=np.uint8)
    got = K.keccak256_fixed_batch(msgs, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (6, 32)
    got = got.numpy()
    if length < K.RATE_BYTES:
        assert (got == JK.keccak256_fixed_batch(msgs)).all()
    for i in range(6):
        assert bytes(got[i].tolist()) == K.keccak256(msgs[i].tobytes())


def test_eth_addresses_batch_matches_jax():
    rng = np.random.default_rng(11)
    pubs = [secp256k1.pubkey_from_private(int.from_bytes(rng.bytes(31), "big") + 1)
            for _ in range(8)]
    got = K.eth_addresses_batch(pubs, device="cpu")
    assert got == JK.eth_addresses_batch(pubs)
    assert got == [K.eth_address(p) for p in pubs]


def _load_fixture_privkeys(n=40):
    with open(cft.reference_path("tests", "keys.ts")) as f:
        text = f.read()
    keys = [int(m.group(1)) for m in re.finditer(r"(\d{10,})n,", text)]
    assert len(keys) >= n
    return keys[:n]


@pytest.mark.skipif(not cft.has_reference(), reason="reference fixtures not mounted")
def test_address_derivation_reproduces_golden_anon_set():
    """pvt -> pubkey -> batched keccak -> address with balance pvt % 1000
    reproduces every row of the reference's golden anonymity-set CSV."""
    with open(cft.reference_path("tests", "1_sigs_1_batches_5_height", "anonymity_set_10.csv")) as f:
        rows = list(csv.reader(f))[1:]
    golden = {int(a, 16): int(b) for a, b in rows}
    pvts = _load_fixture_privkeys(10)
    pubs = [secp256k1.pubkey_from_private(k) for k in pvts]
    addrs = K.eth_addresses_batch(pubs, device="cpu")
    assert {a: p % 1000 for a, p in zip(addrs, pvts)} == golden
    assert addrs == [K.eth_address(p) for p in pubs]
