# Copy of zkpoa_tpu/models/gadgets/keccak_gadget.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Keccak-256 as R1CS constraints (single-block, Ethereum 0x01 padding).

Constraint-side equivalent of the reference's vendored keccak256-circom
(used by circuits/eth.circom PubkeyToAddress, SURVEY.md §2.2), built from
the permutation spec shared with the host/TPU kernels (zkpoa_tpu.ops.keccak):
state bits as signals, xor = a+b-2ab (one product), chi's and-not one
product, rho/pi free rewiring, iota constant xors free on the LC level.

~150k constraints per permutation — used once per pubkey->address
derivation (512-bit message, one block)."""

from __future__ import annotations

from typing import List, Sequence

from ...host import RATE_BYTES, ROUNDS, _RC, _ROT
from ..r1cs import LC, AnyLC, Circuit, _lc


def _const_bit(a: LC):
    """If the LC is a constant (0/1), return its value, else None."""
    if not a.terms:
        return 0
    if set(a.terms) == {0}:
        return a.terms[0]
    return None


def xor2(c: Circuit, a: AnyLC, b: AnyLC) -> LC:
    """a xor b for boolean LCs: a + b - 2ab (linear when either is const)."""
    a, b = _lc(a), _lc(b)
    ca, cb = _const_bit(a), _const_bit(b)
    if ca is not None:
        return xor_const(b, ca)
    if cb is not None:
        return xor_const(a, cb)
    prod = c.mul(a, b)
    return a + b - _lc(prod) * 2


def xor_const(a: AnyLC, bit: int) -> LC:
    """a xor const bit: linear."""
    a = _lc(a)
    return (LC.const(1) - a) if bit else a


def _xor_many(c: Circuit, bits: Sequence[AnyLC]) -> LC:
    acc = _lc(bits[0])
    for b in bits[1:]:
        acc = xor2(c, acc, b)
    return acc


def _rebase(c: Circuit, lc: LC) -> LC:
    """Collapse a wide LC into a fresh signal (one linear constraint).
    Without this, the per-round LC term counts compound ~20x per round and
    the builder goes quadratic-to-exponential."""
    const = _const_bit(lc)
    if const is not None or len(lc.terms) <= 2:
        return lc
    sig = c.var(c.eval_lc(lc))
    c.assert_equal(lc, sig)
    return _lc(sig)


def keccak_f_gadget(c: Circuit, state: List[List[LC]]) -> List[List[LC]]:
    """state: 25 lanes (index i = x + 5y) of 64 little-endian bit LCs."""
    for rnd in range(ROUNDS):
        # theta
        cpar = [
            [_xor_many(c, [state[x + 5 * y][z] for y in range(5)]) for z in range(64)]
            for x in range(5)
        ]
        d = [
            [
                xor2(c, cpar[(x - 1) % 5][z], cpar[(x + 1) % 5][(z - 1) % 64])
                for z in range(64)
            ]
            for x in range(5)
        ]
        state = [
            [xor2(c, state[x + 5 * y][z], d[x][z]) for z in range(64)]
            for y in range(5)
            for x in range(5)
        ]
        # careful: the comprehension above must preserve i = x + 5y ordering:
        # outer y, inner x -> index y*5 + x == x + 5y. OK.

        # rho + pi: b[y][(2x+3y)%5] = rotl(a[x][y], ROT[x][y])
        bstate: List[List[LC]] = [None] * 25  # type: ignore
        for x in range(5):
            for y in range(5):
                src = state[x + 5 * y]
                rot = _ROT[x][y]
                dst = y + 5 * ((2 * x + 3 * y) % 5)
                bstate[dst] = [src[(z - rot) % 64] for z in range(64)]
        # chi: a[x][y] = b[x][y] xor (not b[x+1][y] and b[x+2][y])
        new_state: List[List[LC]] = [None] * 25  # type: ignore
        for y in range(5):
            for x in range(5):
                b0 = bstate[x + 5 * y]
                b1 = bstate[(x + 1) % 5 + 5 * y]
                b2 = bstate[(x + 2) % 5 + 5 * y]
                lane = []
                for z in range(64):
                    not_b1 = LC.const(1) - _lc(b1[z])
                    cn, c2 = _const_bit(not_b1), _const_bit(_lc(b2[z]))
                    if cn is not None:
                        andnot = _lc(b2[z]) * cn
                    elif c2 is not None:
                        andnot = not_b1 * c2
                    else:
                        andnot = _lc(c.mul(not_b1, b2[z]))
                    lane.append(_rebase(c, xor2(c, b0[z], andnot)))
                new_state[x + 5 * y] = lane
        state = new_state
        # iota
        rc = _RC[rnd]
        state[0] = [
            xor_const(state[0][z], (rc >> z) & 1) for z in range(64)
        ]
    return state


def keccak256_gadget(c: Circuit, msg_bits: Sequence[AnyLC]) -> List[LC]:
    """Keccak-256 of a message given as bits (little-endian within each
    byte, bytes in message order). Message must fit one block
    (< RATE_BYTES*8 = 1088 bits). Returns 256 digest bits (same layout)."""
    n_bits = len(msg_bits)
    assert n_bits < RATE_BYTES * 8
    # build the padded block: msg || 0x01 pad || ... || 0x80 at last byte
    block: List[LC] = [_lc(b) for b in msg_bits]
    pad = [0] * (RATE_BYTES * 8 - n_bits)
    pad[0] = 1  # 0x01 at first pad byte's LSB
    pad[-1] ^= 1  # 0x80: MSB of the last byte (bit index 7 of that byte)
    # (bit 7 of last byte is the last element in LE-within-byte layout)
    block += [LC.const(b) for b in pad]

    # bytes -> lanes: lane i (i = x + 5y with x = i % 5, y = i // 5) is
    # bytes [8i, 8i+8) little-endian; bit z of lane = bit (z%8) of byte
    # (8i + z//8) — with LE-within-byte this is just block[64i + z].
    state: List[List[LC]] = []
    for i in range(25):
        if i < RATE_BYTES // 8:
            state.append(block[64 * i : 64 * i + 64])
        else:
            state.append([LC.const(0)] * 64)

    out_state = keccak_f_gadget(c, state)
    digest: List[LC] = []
    for i in range(4):  # 32 bytes = lanes 0..3 (x = i % 5, y = 0)
        digest.extend(out_state[i])
    return digest


def pubkey_to_address_gadget(
    c: Circuit, x_limb_bits: Sequence[Sequence[AnyLC]], y_limb_bits: Sequence[Sequence[AnyLC]]
) -> LC:
    """Ethereum address from a secp256k1 pubkey given as 4x64-bit limb bit
    arrays (little-endian limbs & bits, the bigint range-check bits).

    Equivalent of circuits/eth.circom FlattenPubkey + PubkeyToAddress:
    keccak256(x_be_32B || y_be_32B), take the low 160 bits as an integer."""
    def be_bytes_bits(limb_bits):
        # value bits little-endian: limb j bit i = bit (64j + i).
        # bytes big-endian: byte 0 = bits [248..256) ... keep LE-in-byte.
        val_bits = []
        for limb in limb_bits:
            val_bits.extend(limb)  # little-endian value bits
        assert len(val_bits) == 256
        out = []
        for byte_i in range(32):  # message byte order: most-significant first
            lo = 256 - 8 * (byte_i + 1)
            out.extend(val_bits[lo : lo + 8])  # LE within byte
        return out

    msg_bits = be_bytes_bits(x_limb_bits) + be_bytes_bits(y_limb_bits)
    digest = keccak256_gadget(c, msg_bits)  # 256 bits, LE-in-byte, byte order
    # digest bytes 12..32 are the address, big-endian
    addr = LC.const(0)
    for byte_i in range(12, 32):
        byte_bits = digest[8 * byte_i : 8 * byte_i + 8]
        byte_weight = 1 << (8 * (31 - byte_i))
        for bit_i, b in enumerate(byte_bits):
            addr = addr + _lc(b) * (byte_weight << bit_i)
    return addr
