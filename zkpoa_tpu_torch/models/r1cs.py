# Copy of zkpoa_tpu/models/r1cs.py; its imports are rewritten and R1CS.pack packs the port's 8 x 32-bit limbs.
"""R1CS constraint-system builder — the framework's circuit frontend.

Plays the role circom + the vendored gadget libraries play in the reference
(SURVEY.md §2.1-2.2): circuits are built as Python gadget functions that
emit rank-1 constraints  <A,w>·<B,w> = <C,w>  over BN254 Fr and compute the
witness eagerly as they build (each signal carries its concrete value).
Layer circuits live in zkpoa_tpu.models.layers/gadgets; the Groth16
setup/prover consume the sparse matrices produced here.

Wire 0 is the constant 1 (circom convention). The witness vector is
[1, publics..., privates...]; public wires are allocated first so the
verifier-side IC indexing matches snarkjs semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..fields.bn254 import R as P


class LC:
    """Linear combination over wires: sum coeff_i * w_i (+ const via wire 0)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[int, int]] = None):
        self.terms = terms or {}

    @classmethod
    def const(cls, c: int) -> "LC":
        c %= P
        return cls({0: c} if c else {})

    def __add__(self, other: "AnyLC") -> "LC":
        other = _lc(other)
        out = dict(self.terms)
        for w, c in other.terms.items():
            v = (out.get(w, 0) + c) % P
            if v:
                out[w] = v
            else:
                out.pop(w, None)
        return LC(out)

    def __sub__(self, other: "AnyLC") -> "LC":
        return self + _lc(other) * (P - 1)

    def __rsub__(self, other: "AnyLC") -> "LC":
        return _lc(other) + self * (P - 1)

    __radd__ = __add__

    def __mul__(self, scalar: int) -> "LC":
        scalar %= P
        return LC({w: c * scalar % P for w, c in self.terms.items() if c * scalar % P})

    __rmul__ = __mul__

    def __neg__(self) -> "LC":
        return self * (P - 1)


class Signal(LC):
    """A single wire, usable anywhere an LC is."""

    __slots__ = ("wire", "circuit")

    def __init__(self, circuit: "Circuit", wire: int):
        super().__init__({wire: 1})
        self.wire = wire
        self.circuit = circuit

    @property
    def value(self) -> int:
        return self.circuit.witness[self.wire]


AnyLC = Union[LC, Signal, int]


def _lc(x: AnyLC) -> LC:
    if isinstance(x, LC):
        return x
    return LC.const(int(x))


class RowList:
    """Sparse constraint rows stored packed: (constraint, wire) as int64
    arrays plus dictionary-encoded coefficients in a pool SHARED across a
    circuit's three matrices. Behaves like a list of (i, wire, coeff)
    tuples for consumers, but costs ~24B/row instead of ~100B+ (tuple
    rows were the bulk of the 29GB layer-2 build RSS) and converts to the
    device-SpMV PackedMatrix with zero Python-loop work."""

    __slots__ = ("idx", "wire", "cid", "pool", "pool_index")

    def __init__(self, pool=None, pool_index=None):
        from array import array

        self.idx = array("q")
        self.wire = array("q")
        self.cid = array("q")
        self.pool = pool if pool is not None else [1]
        self.pool_index = pool_index if pool_index is not None else {1: 0}

    def append(self, row) -> None:
        i, w, coeff = row
        j = self.pool_index.get(coeff)
        if j is None:
            j = len(self.pool)
            self.pool_index[coeff] = j
            self.pool.append(coeff)
        self.idx.append(i)
        self.wire.append(w)
        self.cid.append(j)

    def cid_of(self, coeff: int) -> int:
        """Pool id for a coefficient (interning it on first sight)."""
        j = self.pool_index.get(coeff)
        if j is None:
            j = len(self.pool)
            self.pool_index[coeff] = j
            self.pool.append(coeff)
        return j

    def extend_cols(self, idx_it, wire_it, cid_it) -> None:
        """Bulk append pre-interned rows (cid values from cid_of).
        Consumers require idx to stay non-decreasing across calls — the
        caller emits whole consecutive constraint ranges."""
        self.idx.extend(idx_it)
        self.wire.extend(wire_it)
        self.cid.extend(cid_it)

    def extend_at(self, i: int, terms) -> None:
        """Bulk append every (wire, coeff) term of ONE constraint i —
        one C-level idx fill instead of a Python append per row."""
        wire = self.wire
        cid = self.cid
        pi = self.pool_index
        pool = self.pool
        n0 = len(wire)
        for w, co in terms:
            j = pi.get(co)
            if j is None:
                j = len(pool)
                pi[co] = j
                pool.append(co)
            wire.append(w)
            cid.append(j)
        self.idx.extend([i] * (len(wire) - n0))

    def __len__(self) -> int:
        return len(self.idx)

    def __bool__(self) -> bool:
        return len(self.idx) > 0

    def __iter__(self):
        pool = self.pool
        for i, w, j in zip(self.idx, self.wire, self.cid):
            yield (i, w, pool[j])

    def __getitem__(self, key):
        pool = self.pool
        if isinstance(key, slice):
            return [
                (i, w, pool[j])
                for i, w, j in zip(self.idx[key], self.wire[key], self.cid[key])
            ]
        return (self.idx[key], self.wire[key], pool[self.cid[key]])


@dataclass
class PackedMatrix:
    """One sparse matrix as parallel int32 numpy arrays (constraint index,
    wire index, coefficient-pool id) — ~20x smaller than tuple rows and
    directly consumable by the device SpMV (ops/qap_eval.py)."""

    idx: "np.ndarray"
    wire: "np.ndarray"
    cid: "np.ndarray"


@dataclass
class PackedR1CS:
    """Dictionary-encoded constraint system: the row coefficients live in
    a (small) shared pool — gadget coefficients are structural constants
    (±1, powers of two, round constants), so distinct values number in the
    thousands even at tens of millions of rows."""

    a: PackedMatrix
    b: PackedMatrix
    c: PackedMatrix
    pool_limbs: "np.ndarray"  # [n_pool, 8] int32 plain 32-bit limbs
    n_wires: int
    n_public: int
    n_constraints: int


def _pack_rows(rows, pool: dict, pool_vals: list) -> PackedMatrix:
    import numpy as np

    m = len(rows)
    idx = np.empty(m, np.int32)
    wire = np.empty(m, np.int32)
    cid = np.empty(m, np.int32)
    for t, (i, w, c) in enumerate(rows):
        idx[t] = i
        wire[t] = w
        j = pool.get(c)
        if j is None:
            j = len(pool_vals)
            pool[c] = j
            pool_vals.append(c)
        cid[t] = j
    return PackedMatrix(idx, wire, cid)


@dataclass
class R1CS:
    """Frozen constraint system: sparse rows as (constraint, wire, coeff)."""

    n_wires: int
    n_public: int  # count of public *input/output* wires (excl. wire 0)
    a_rows: List[Tuple[int, int, int]]
    b_rows: List[Tuple[int, int, int]]
    c_rows: List[Tuple[int, int, int]]
    n_constraints: int

    def pack(self) -> PackedR1CS:
        """Packed numpy form (cached): feeds the device QAP evaluation
        (ops/qap_eval.eval_matrices_device). RowList-backed circuits
        convert with zero per-row Python work."""
        import numpy as np

        cached = getattr(self, "_packed", None)
        if cached is not None:
            return cached
        from ..host import scalars_to_limbs_fast

        # a shared coefficient pool across the three matrices: RowList
        # matrices already share their circuit's pool (ids stay valid);
        # plain-list matrices dictionary-encode into the same pool
        pool_index: dict = {}
        pool_vals: list = []
        for rows in (self.a_rows, self.b_rows, self.c_rows):
            if isinstance(rows, RowList):
                assert not pool_vals or pool_vals is rows.pool, (
                    "mixed RowList pools in one R1CS"
                )
                pool_vals = rows.pool
                pool_index = rows.pool_index
        if not pool_vals:
            pool_vals = [1]
            pool_index = {1: 0}

        def pm(rows) -> PackedMatrix:
            if isinstance(rows, RowList):
                return PackedMatrix(
                    idx=np.frombuffer(rows.idx, dtype=np.int64).astype(np.int32),
                    wire=np.frombuffer(rows.wire, dtype=np.int64).astype(np.int32),
                    cid=np.frombuffer(rows.cid, dtype=np.int64).astype(np.int32),
                )
            return _pack_rows(rows, pool_index, pool_vals)

        packed = PackedR1CS(
            a=pm(self.a_rows), b=pm(self.b_rows), c=pm(self.c_rows),
            pool_limbs=scalars_to_limbs_fast(pool_vals),
            n_wires=self.n_wires, n_public=self.n_public,
            n_constraints=self.n_constraints,
        )
        object.__setattr__(self, "_packed", packed)
        return packed

    def eval_matrices(self, witness: Sequence[int]):
        """Return per-constraint <A,w>, <B,w>, <C,w> (exact host ints)."""
        a = [0] * self.n_constraints
        b = [0] * self.n_constraints
        c = [0] * self.n_constraints
        for i, w, coeff in self.a_rows:
            a[i] = (a[i] + coeff * witness[w]) % P
        for i, w, coeff in self.b_rows:
            b[i] = (b[i] + coeff * witness[w]) % P
        for i, w, coeff in self.c_rows:
            c[i] = (c[i] + coeff * witness[w]) % P
        return a, b, c

    def is_satisfied(self, witness: Sequence[int]) -> bool:
        a, b, c = self.eval_matrices(witness)
        return all(ai * bi % P == ci for ai, bi, ci in zip(a, b, c))


class Circuit:
    """Eager builder: allocating a signal records its witness value; adding a
    constraint records sparse rows and (optionally) checks satisfaction."""

    def __init__(self, check: bool = True):
        self.witness: List[int] = [1]
        self._public_wires: List[int] = []
        pool: List[int] = [1]
        pool_index = {1: 0}
        self.a_rows = RowList(pool, pool_index)
        self.b_rows = RowList(pool, pool_index)
        self.c_rows = RowList(pool, pool_index)
        self.n_constraints = 0
        self.check = check
        self._finalized_public = False

    # -- signals ---------------------------------------------------------

    def var(self, value: int) -> Signal:
        wire = len(self.witness)
        self.witness.append(int(value) % P)
        return Signal(self, wire)

    def public(self, value: int) -> Signal:
        """Allocate a public wire. Must be called before any private var
        (snarkjs wire-ordering convention)."""
        if len(self.witness) != len(self._public_wires) + 1:
            raise RuntimeError("public signals must be allocated first")
        sig = self.var(value)
        self._public_wires.append(sig.wire)
        return sig

    def public_output(self) -> Signal:
        """Allocate a public wire whose value is computed later (circom puts
        outputs first in the wire order). Bind with bind_output()."""
        if len(self.witness) != len(self._public_wires) + 1:
            raise RuntimeError("public signals must be allocated first")
        wire = len(self.witness)
        self.witness.append(None)  # resolved by bind_output
        self._public_wires.append(wire)
        return Signal(self, wire)

    def bind_output(self, sig: Signal, lc: AnyLC) -> None:
        """Assign a public-output wire its computed value and constrain
        equality sig == lc."""
        if self.witness[sig.wire] is not None:
            raise RuntimeError("output already bound")
        self.witness[sig.wire] = self.eval_lc(lc)
        self.assert_equal(sig, lc)

    def eval_lc(self, lc: AnyLC) -> int:
        lc = _lc(lc)
        return sum(c * self.witness[w] for w, c in lc.terms.items()) % P

    # -- constraints -----------------------------------------------------

    def constrain(self, a: AnyLC, b: AnyLC, c: AnyLC) -> None:
        """Add a*b = c."""
        a, b, c = _lc(a), _lc(b), _lc(c)
        i = self.n_constraints
        for w, coeff in a.terms.items():
            self.a_rows.append((i, w, coeff))
        for w, coeff in b.terms.items():
            self.b_rows.append((i, w, coeff))
        for w, coeff in c.terms.items():
            self.c_rows.append((i, w, coeff))
        self.n_constraints += 1
        if self.check:
            va, vb, vc = self.eval_lc(a), self.eval_lc(b), self.eval_lc(c)
            if va * vb % P != vc:
                raise AssertionError(
                    f"constraint {i} unsatisfied: {va} * {vb} != {vc}"
                )

    def assert_equal(self, a: AnyLC, b: AnyLC) -> None:
        self.constrain(_lc(a) - _lc(b), LC.const(1), LC.const(0))

    def mul(self, a: AnyLC, b: AnyLC) -> Signal:
        """Allocate product signal with constraint a*b = out."""
        out = self.var(self.eval_lc(a) * self.eval_lc(b) % P)
        self.constrain(a, b, out)
        return out

    def add_lc(self, a: AnyLC, b: AnyLC) -> LC:
        return _lc(a) + _lc(b)

    # -- raw fast paths (identical R1CS semantics, no LC objects) ----------
    # Used by the constraint-heavy foreign-field/pairing gadgets where the
    # Python object layer would dominate build time (millions of rows).

    def raw_bits(self, val: int, n: int) -> List[int]:
        """Allocate n bit wires for `val` with boolean constraints
        b*(b-1)=0; returns wire indices (LSB first). The caller must add
        the recomposition constraint binding them to a value.

        Bulk-emits all 3n rows with C-level slice/extend ops — the
        per-bit append loop was ~84% of layer-1 circuit build time
        (bit decomposition dominates the foreign-field gadgets)."""
        w = self.witness
        i0 = self.n_constraints
        w0 = len(w)
        w.extend([(val >> t) & 1 for t in range(n)])
        rng_i = range(i0, i0 + n)
        rng_w = range(w0, w0 + n)
        # A: (ci, bit_wire, 1) — cid 0 is always coeff 1
        self.a_rows.extend_cols(rng_i, rng_w, bytes(n))
        # B: (ci, bit_wire, 1), (ci, const_wire, -1) interleaved so idx
        # stays sorted by constraint (native r1cs_eval contract)
        b = self.b_rows
        jm = b.cid_of(P - 1)
        idx2 = [0] * (2 * n)
        idx2[0::2] = rng_i
        idx2[1::2] = rng_i
        wire2 = [0] * (2 * n)
        wire2[0::2] = rng_w
        cid2 = [0] * (2 * n)
        cid2[1::2] = [jm] * n
        b.extend_cols(idx2, wire2, cid2)
        self.n_constraints = i0 + n
        return list(rng_w)

    def raw_constrain(self, a_terms, b_terms, c_terms) -> None:
        """Append one constraint from (wire, coeff) iterables directly.
        Coefficients must already be reduced mod P."""
        i = self.n_constraints
        if a_terms:
            self.a_rows.extend_at(i, a_terms)
        if b_terms:
            self.b_rows.extend_at(i, b_terms)
        if c_terms:
            self.c_rows.extend_at(i, c_terms)
        self.n_constraints = i + 1

    def raw_var(self, value: int) -> int:
        """Allocate a wire (value already reduced) and return its index."""
        wire = len(self.witness)
        self.witness.append(value)
        return wire

    # -- export ----------------------------------------------------------

    def compile(self) -> Tuple[R1CS, List[int]]:
        if any(v is None for v in self.witness):
            raise RuntimeError("unbound public_output wire(s)")
        r1cs = R1CS(
            n_wires=len(self.witness),
            n_public=len(self._public_wires),
            # RowLists are handed over by reference (packed storage; a
            # list() copy would re-materialize the tuple rows this
            # representation exists to avoid)
            a_rows=self.a_rows,
            b_rows=self.b_rows,
            c_rows=self.c_rows,
            n_constraints=self.n_constraints,
        )
        return r1cs, list(self.witness)

    @property
    def public_values(self) -> List[int]:
        return [self.witness[w] for w in self._public_wires]
