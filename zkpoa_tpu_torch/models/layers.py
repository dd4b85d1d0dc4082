# Copy of zkpoa_tpu/models/layers.py; only its imports are rewritten for zkpoa_tpu_torch.
"""Protocol layer circuits (the framework's "model zoo").

Parity map to the reference (SURVEY.md §2.1):
  * layer_one (batch-ECDSA* verify + pubkey sponge)  — gadget roadmap:
    secp256k1 bigint gadgets (rounds 2+); host/TPU verification of the same
    statement exists today in zkpoa_tpu.fields.secp256k1 / pipeline.
  * layer_two (in-snark G16 verify + address derive + Merkle + sum):
    `membership_sum_circuit` below implements the accounting core —
    Poseidon leaf hashing, Merkle inclusion against the public root,
    strictly-ascending address anti-double-count, balance summation —
    i.e. circuits/layer_two.circom:71-124 minus the recursive verifier and
    Keccak address derivation (those gadgets land in later rounds).
  * layer_three (aggregate + Pedersen commitment): host/TPU Pedersen is in
    fields.curve25519 / pipeline; the ed25519 scalar-mul gadget follows the
    same roadmap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from .gadgets import bigint as B
from .gadgets import ec as E
from .gadgets.core import assert_less_than
from .gadgets.merkle_gadget import merkle_verify
from .gadgets.poseidon_gadget import poseidon, poseidon_sponge
from .r1cs import Circuit, R1CS


@dataclass
class LayerOneInput:
    """One signature's registers, in the reference's 64x4 limb layout
    (circuits/layer_one.circom:19-23; little-endian limbs)."""

    r: List[int]
    rprime: List[int]
    s: List[int]
    msghash: List[int]
    pubkey: List[List[int]]  # [x_limbs, y_limbs]

    @classmethod
    def from_json_entry(cls, d: dict, i: int) -> "LayerOneInput":
        g = lambda key: [int(x) for x in d[key][i]]
        return cls(
            r=g("r"),
            rprime=g("rprime"),
            s=g("s"),
            msghash=g("msghash"),
            pubkey=[[int(x) for x in d["pubkey"][i][0]], [int(x) for x in d["pubkey"][i][1]]],
        )


def layer_one_circuit(sigs: Sequence[LayerOneInput], check: bool = False) -> Circuit:
    """LayerOne(num_sigs): verify every ECDSA* signature in-circuit and
    output the Poseidon sponge of the pubkey x-coordinate registers.

    Statement parity with circuits/layer_one.circom: same input registers,
    same single public output `pubkey_x_coord_hash` = PoseidonSponge over
    num_sigs*4 x-coord limbs (circuits/layer_one.circom:54-63). The
    verification core is randomized-batch ECDSA* (the reference's
    BatchECDSAVerifyNoPubkeyCheck dispatch, circuits/layer_one.circom:40-49)
    with a direct single-equation path at num_sigs == 1 — one shared
    doubling ladder for the whole batch (gadgets/ecdsa_batch.py)."""
    from .gadgets.ecdsa_batch import batch_ecdsa_star_verify

    c = Circuit(check=check)
    out = c.public_output()

    fr, fq = B.SECP_FR, B.SECP_FQ
    sponge_inputs = []
    sig_ffs = []
    for i, sig in enumerate(sigs):
        r_sigs = [c.var(v) for v in sig.r]
        rp_sigs = [c.var(v) for v in sig.rprime]
        s_sigs = [c.var(v) for v in sig.s]
        m_sigs = [c.var(v) for v in sig.msghash]
        px_sigs = [c.var(v) for v in sig.pubkey[0]]
        py_sigs = [c.var(v) for v in sig.pubkey[1]]

        sig_ffs.append(
            {
                "r": B.ff_input(c, fr, r_sigs, sig.r),
                "rprime": B.ff_input(c, fq, rp_sigs, sig.rprime),
                "s": B.ff_input(c, fr, s_sigs, sig.s),
                "msghash": B.ff_input(c, fr, m_sigs, sig.msghash),
                "pubkey": E.ECPoint(
                    B.ff_input(c, fq, px_sigs, sig.pubkey[0]),
                    B.ff_input(c, fq, py_sigs, sig.pubkey[1]),
                ),
            }
        )
        sponge_inputs.extend(px_sigs)

    batch_ecdsa_star_verify(c, sig_ffs)
    c.bind_output(out, poseidon_sponge(c, sponge_inputs))
    return c


@dataclass
class LayerTwoInput:
    """Reference layer-2 input shape (layer_two_batch_N_input.json):
    the sanitized layer-1 proof registers, pubkeys, and Merkle data."""

    pubkey_x_coord_hash: int
    pubkeys: List[List[List[int]]]  # [n][2][4] 64-bit limbs
    merkle_root: int
    leaf_addresses: List[int]
    leaf_balances: List[int]
    path_elements: List[List[int]]
    path_indices: List[List[int]]
    # sanitized proof registers (in-snark verification inputs; bound when
    # the recursive-verifier gadget lands)
    proof: dict | None = None

    @classmethod
    def from_json(cls, d: dict) -> "LayerTwoInput":
        n = len(d["pubkey"])
        return cls(
            pubkey_x_coord_hash=int(d["pubkey_x_coord_hash"]),
            pubkeys=[[[int(x) for x in reg] for reg in pk] for pk in d["pubkey"]],
            merkle_root=int(d["merkle_root"]),
            leaf_addresses=[int(x) for x in d["leaf_addresses"]],
            leaf_balances=[int(x) for x in d["leaf_balances"]],
            path_elements=[[int(x) for x in row] for row in d["path_elements"]],
            path_indices=[[int(x) for x in row] for row in d["path_indices"]],
            proof={
                k: d[k]
                for k in ("negalfa1xbeta2", "gamma2", "delta2", "IC", "negpa", "pb", "pc")
                if k in d
            },
        )


def layer_two_circuit(
    inp: LayerTwoInput,
    tree_height: int,
    check: bool = False,
    inner_vk=None,
) -> Circuit:
    """LayerTwo(num_sigs, merkle_tree_height): constrain the Poseidon
    sponge of the pubkey x-coord registers to the claimed layer-1 public
    input, derive each Ethereum address in-circuit (Keccak-256), enforce
    strictly-ascending addresses (the reference only asserts this at
    witness time, circuits/layer_two.circom:78-87 — ours is a constraint),
    verify Poseidon-Merkle inclusion of every (address, balance) leaf, and
    output the balance sum. Public signals: [balance_sum, merkle_root].

    With `inner_vk` (a pairing_gadget.PreparedVK for the layer-1 circuit),
    the layer-1 proof carried in inp.proof is verified IN-SNARK against
    pubkey_x_coord_hash — the reference's circuits/layer_two.circom:44-49
    (circom-pairing verifyProof, ~19.5M constraints there; ~7M here via
    the residue-witness design, models/gadgets/pairing_gadget.py)."""
    from .gadgets import bigint as B
    from .gadgets.keccak_gadget import pubkey_to_address_gadget
    from .gadgets.poseidon_gadget import poseidon_sponge

    n = len(inp.pubkeys)
    levels = tree_height - 1
    c = Circuit(check=check)
    out = c.public_output()
    root = c.public(inp.merkle_root)

    hash_sig = c.var(inp.pubkey_x_coord_hash)

    from .gadgets.core import num2bits

    addr_lcs = []
    sponge_inputs = []
    for i in range(n):
        px = [c.var(v) for v in inp.pubkeys[i][0]]
        py = [c.var(v) for v in inp.pubkeys[i][1]]
        # num2bits is both the 64-bit range check and the FlattenPubkey
        # bit supply for the Keccak address derivation (circuits/eth.circom)
        x_bits = [num2bits(c, px[j], 64) for j in range(4)]
        y_bits = [num2bits(c, py[j], 64) for j in range(4)]
        addr_lcs.append(pubkey_to_address_gadget(c, x_bits, y_bits))
        sponge_inputs.extend(px)

    c.assert_equal(poseidon_sponge(c, sponge_inputs), hash_sig)

    total = None
    addr_sigs = []
    for i in range(n):
        addr = c.var(inp.leaf_addresses[i])
        bal = c.var(inp.leaf_balances[i])
        c.assert_equal(addr_lcs[i], addr)
        leaf = poseidon(c, [addr, bal])
        path_el = [c.var(x) for x in inp.path_elements[i][:levels]]
        path_ix = [c.var(x) for x in inp.path_indices[i][:levels]]
        merkle_verify(c, leaf, root, path_el, path_ix)
        total = bal if total is None else total + bal
        addr_sigs.append(addr)
        if i > 0:
            assert_less_than(c, addr_sigs[i - 1], addr, 160)

    c.bind_output(out, total if total is not None else 0)

    if inner_vk is not None:
        from .gadgets.pairing_gadget import groth16_verify_gadget, proof_signals_from_sanitized

        assert inp.proof, "layer-2 recursion requires the sanitized layer-1 proof"
        negpa, pb, pc = proof_signals_from_sanitized(c, inp.proof)
        groth16_verify_gadget(c, inner_vk, negpa, pb, pc, [hash_sig])
    return c


def layer_three_circuit(
    balances: Sequence[int],
    merkle_root: int,
    blinding_factor: int,
    check: bool = False,
    inner: Sequence = (),
) -> Circuit:
    """LayerThree(layer_two_count): sum the per-batch balances and commit to
    the total with a Curve25519 Pedersen commitment.

    Statement parity with circuits/layer_three.circom: public signals are
    the 12 commitment registers (4 extended coords x 3 x 85-bit limbs,
    circuits/layer_three.circom:64-80) followed by the public merkle_root;
    balances and the 255 blinding bits are private. Projective coordinates
    are algorithm-dependent, so parity is point equality (the reference's
    own checker semantics, scripts/pedersen_commitment_checker.ts:58-63).

    With `inner` (a sequence of (pairing_gadget.PreparedVK, sanitized
    layer-2 proof dict), one per batch), every layer-2 proof is verified
    IN-SNARK against the public pair [balance_b, merkle_root] — the
    reference's verifyProof loop (circuits/layer_three.circom:41-48),
    binding each balance to a real accounting proof.
    """
    from .gadgets import edwards as Ed
    from .gadgets.core import num2bits

    c = Circuit(check=check)
    out_regs = [c.public_output() for _ in range(12)]
    root = c.public(merkle_root)

    bal_sigs = [c.var(b) for b in balances]
    total_lc = bal_sigs[0]
    total = balances[0]
    for b_sig, b in zip(bal_sigs[1:], balances[1:]):
        total_lc = total_lc + b_sig
        total += b

    secret_bits = num2bits(c, total_lc, 255)
    secret_vals = [(total >> i) & 1 for i in range(255)]

    blind_vals = [(blinding_factor >> i) & 1 for i in range(255)]
    blind_bits = [c.var(v) for v in blind_vals]
    for b_sig in blind_bits:
        c.constrain(b_sig, b_sig - 1, 0)

    com = Ed.pedersen_commitment_gadget(c, secret_bits, secret_vals, blind_bits, blind_vals)
    for ci, coord in enumerate((com.x, com.y, com.z, com.t)):
        for li in range(3):
            c.bind_output(out_regs[ci * 3 + li], coord.limbs[li])

    if inner:
        from .gadgets.pairing_gadget import groth16_verify_gadget, proof_signals_from_sanitized

        assert len(inner) == len(balances), "one layer-2 proof per batch"
        for b_sig, (pvk, proof_dict) in zip(bal_sigs, inner):
            negpa, pb, pc = proof_signals_from_sanitized(c, proof_dict)
            groth16_verify_gadget(c, pvk, negpa, pb, pc, [b_sig, root])
    return c


@dataclass
class MembershipWitnessInput:
    """Per-owned-account private data (address, balance, Merkle path)."""

    address: int
    balance: int
    path_elements: List[int]
    path_indices: List[int]


def membership_sum_circuit(
    merkle_root: int,
    accounts: Sequence[MembershipWitnessInput],
    tree_levels: int,
) -> Circuit:
    """Prove: every (address, balance) is a leaf of the tree with
    `merkle_root`; addresses strictly ascend (no double counting,
    circuits/layer_two.circom:78-87); output their balance sum.

    Public wires (in order): [balance_sum (output), merkle_root (input)] —
    matching the reference's layer-2 public signature
    (scripts/generate_circuits.ts:88: only merkle_root is a public input;
    balance_sum is the public output)."""
    c = Circuit()
    balance_sum_out = c.public_output()
    root = c.public(merkle_root)

    addr_sigs = []
    total = None
    for acct in accounts:
        addr = c.var(acct.address)
        bal = c.var(acct.balance)
        leaf = poseidon(c, [addr, bal])
        assert len(acct.path_elements) == tree_levels
        path_el = [c.var(x) for x in acct.path_elements]
        path_ix = [c.var(x) for x in acct.path_indices]
        merkle_verify(c, leaf, root, path_el, path_ix)
        addr_sigs.append(addr)
        total = bal if total is None else total + bal

    # strictly ascending addresses (160-bit compare)
    for prev, cur in zip(addr_sigs, addr_sigs[1:]):
        assert_less_than(c, prev, cur, 160)

    c.bind_output(balance_sum_out, total if total is not None else 0)
    return c
