"""Witness sanitizer: range checks over a whole witness batch, on numpy or on
int64 tensors on any device; and digests of a circuit's structure and of a
value table.

Counterpart of ``plonky2_ecdsa_tpu.utils.debug``.  ``witness_violations``
validates a witness matrix against the contracts the proof system ASSUMES of
an honest witness:

  * canonicity   every wire value < Goldilocks p;
  * range pools  every pooled range-checked value (29-bit limbs, 34-bit
                 nonnative-mul carries) within its declared bound, and every
                 derived lookup limb within the scaled table bound.

A violation means a fault in a witness generator: the proof would fail
anyway, but with an opaque quotient or lookup mismatch; this reports counts
per class instead.  ``prover.prove`` runs it on the uploaded wires when
PLONKY2_TPU_DEBUG=1.  It does not evaluate the gates: a witness that is well
formed but wrong for the circuit (a tampered inner proof fed to a verifier
circuit) passes here and fails ``circuit.witness.check_constraints``.

``structure_digest`` names a built circuit by what its proofs depend on, so
two builds (two packages, two machines) can be compared by one value;
``value_table_digest`` does the same for a witness tape's value table, and
``gate_histogram`` / ``gate_rows_used`` count a circuit's rows by gate.
``EagerOpCounter`` counts the torch ops a stretch of code dispatches, and
``quotient_gate_ops`` those of the quotient's gate section a domain chunk.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..circuit.gates import RangeLookupGate
from ..fields import goldilocks as gl

_M64 = (1 << 64) - 1


class _NumpyU64:
    """The sanitizer's three primitives on numpy u64 arrays."""

    @staticmethod
    def index(x):
        return x

    @staticmethod
    def shr(x, bits: int):
        return x >> np.uint64(bits)

    @staticmethod
    def below(x, bound: int):
        """Unsigned x < bound, bound < 2^64."""
        return x < np.uint64(bound)

    @staticmethod
    def total(x) -> int:
        """The sum modulo 2^64, as numpy's u64 sum wraps."""
        return int(x.sum())


class _TensorU64:
    """The same on int64 tensors holding u64 bit patterns: an unsigned
    compare and a logical shift (gl.ult, gl.shr), and a sum taken over the
    32-bit halves (no int64 overflow), wrapped modulo 2^64 as numpy's."""

    def __init__(self, device):
        self.device = device

    def index(self, x):
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    @staticmethod
    def shr(x, bits: int):
        return gl.shr(x, bits)

    @staticmethod
    def below(x, bound: int):
        return gl.ult(x, bound - (1 << 64) if bound >> 63 else bound)

    @staticmethod
    def total(x) -> int:
        return (int((x & gl.M32).sum()) + (int(gl.shr(x, 32).sum()) << 32)) & _M64


def witness_violations(circuit, W) -> dict:
    """Violation counts per class for a witness matrix W [wires, n, B] of u64
    values (a numpy array, or an int64 tensor of their bit patterns on any
    device): {"canonicity": k, "range_<bits>": k, "lookup_limb_<bits>": k},
    zero everywhere for an honest witness.  A value over its bound weighs in
    with its bits above the bound (v >> bits), summed modulo 2^64, as in the
    reference, so one wildly corrupt value can count for more than one.  The
    counts are Python ints, equal for both forms of the same witness."""
    if isinstance(W, torch.Tensor):
        if W.dtype != torch.int64:
            raise ValueError(f"witness_violations: needs an int64 tensor, got {W.dtype}")
        u = _TensorU64(W.device)
    else:
        W, u = np.asarray(W, np.uint64), _NumpyU64
    out = {"canonicity": int((~u.below(W, gl.P)).sum())}
    for gi, gate in enumerate(circuit.gates):
        if not isinstance(gate, RangeLookupGate):
            continue
        rows = u.index(circuit.gate_rows[gi])
        lb = gate.limb_bits
        # declared bound on each pooled value (the value wires are cols 0..V-1)
        vals = W[:gate.num_vals][:, rows, :]
        key = f"range_{gate.bits}"
        out[key] = (out.get(key, 0) + u.total(u.shr(vals, gate.bits))) & _M64
        # derived limbs must sit inside the (scaled) lookup table range
        limb_cols = u.index([gate.wire_limb(v, j) for v in range(gate.num_vals)
                             for j in range(gate.num_limbs)])
        lbad = u.total(u.shr(W[limb_cols][:, rows, :], lb))
        if gate.scale > 1:
            top_cols = u.index([gate.wire_limb(v, gate.num_limbs - 1)
                                for v in range(gate.num_vals)])
            tops = W[top_cols][:, rows, :]
            # scale-check only tops that pass the plain limb bound: a wildly
            # corrupt top could wrap tops * scale in u64 and be missed here
            # (the plain check above has already counted it); the product of
            # an in-range top is small, so it is taken of those alone
            in_range = u.below(tops, 1 << lb)
            scaled = (tops * in_range) * gate.scale
            lbad += int((in_range & (u.shr(scaled, lb) != 0)).sum())
        lkey = f"lookup_limb_{gate.bits}"
        out[lkey] = (out.get(lkey, 0) + lbad) & _M64
    return out


def assert_witness_ok(circuit, W) -> None:
    """Raise AssertionError naming every violated contract class."""
    bad = {k: v for k, v in witness_violations(circuit, W).items() if v}
    assert not bad, f"witness sanitizer violations: {bad}"


def structure_digest(circuit) -> str:
    """sha256 over the circuit's n, the gate id of every row, its constant
    columns, its copy classes (the sigma columns) and its public-input
    targets."""
    h = hashlib.sha256()
    h.update(str(circuit.n).encode())
    h.update("|".join(circuit.gates[gi].gate_id() for gi in circuit.row_gate_idx).encode())
    for a in (circuit.constants, circuit.sigmas):
        h.update(np.ascontiguousarray(a, "<u8").tobytes())
    h.update(np.ascontiguousarray(circuit.pi_tids, "<i8").tobytes())
    return h.hexdigest()


def value_table_digest(vals) -> str:
    """sha256 of a value table [T, B] (u64, little-endian bytes)."""
    return hashlib.sha256(np.ascontiguousarray(vals, "<u8").tobytes()).hexdigest()


def gate_histogram(circuit) -> dict:
    """{gate id: rows holding it}."""
    return {g.gate_id(): len(circuit.gate_rows.get(gi, ())) for gi, g in enumerate(circuit.gates)}


def gate_rows_used(circuit) -> int:
    """Rows that hold a gate other than Noop (padding)."""
    return sum(k for gid, k in gate_histogram(circuit).items() if gid != "Noop")


class EagerOpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched inside its `with` block, views
    included: what eager code issues one op at a time from the host, on any
    device (``with EagerOpCounter() as c: ...; c.count``)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def quotient_gate_ops(gates, num_consts: int, challenges: int, device="cpu") -> int:
    """Eager torch ops that the quotient's gate section
    (``prover._add_gate_constraints``) issues for one domain chunk of a
    circuit with these gates, counted on random inputs [B=2, 8 points]: the
    count does not depend on the chunk's shape.  A first, uncounted pass
    makes the gates' cached constants.  On a CUDA device the field
    operations are launches of fields/goldilocks_cuda's kernels, which a
    dispatch mode does not see: there it counts the rest."""
    from ..circuit.algebra import TorchAlgebra
    from ..prover import prover

    rng = np.random.default_rng(0)

    def field(*shape):
        return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64), device)

    B, m = 2, 8
    w = field(B, max(g.num_wires for g in gates), m)
    fixed = field(num_consts + len(gates), m)
    pic = field(B, max(getattr(g, "num_cols", 1) for g in gates), m)
    apows = [field(B, max(g.num_constraints for g in gates)) for _ in range(challenges)]
    comb = [field(B, m) for _ in range(challenges)]
    alg = TorchAlgebra((B, m), device)
    prover._add_gate_constraints(alg, comb, gates, w, fixed, pic, apows, 0, num_consts)
    with EagerOpCounter() as counter:
        prover._add_gate_constraints(alg, comb, gates, w, fixed, pic, apows, 0, num_consts)
    return counter.count
