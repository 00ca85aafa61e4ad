"""Witness sanitizer: range checks over a whole witness batch, on numpy; and
digests of a circuit's structure and of a value table.

Counterpart of ``plonky2_ecdsa_tpu.utils.debug``.  ``witness_violations``
validates a witness matrix against the contracts the proof system ASSUMES of
an honest witness:

  * canonicity   every wire value < Goldilocks p;
  * range pools  every pooled range-checked value (29-bit limbs, 34-bit
                 nonnative-mul carries) within its declared bound, and every
                 derived lookup limb within the scaled table bound.

A violation means a fault in a witness generator: the proof would fail
anyway, but with an opaque quotient or lookup mismatch; this reports counts
per class instead.  It does not evaluate the gates: a witness that is well
formed but wrong for the circuit (a tampered inner proof fed to a verifier
circuit) passes here and fails ``circuit.witness.check_constraints``.

``structure_digest`` names a built circuit by what its proofs depend on, so
two builds (two packages, two machines) can be compared by one value;
``value_table_digest`` does the same for a witness tape's value table, and
``gate_histogram`` / ``gate_rows_used`` count a circuit's rows by gate.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..circuit.gates import RangeLookupGate
from ..fields import goldilocks as gl


def witness_violations(circuit, W) -> dict:
    """Violation counts per class for a witness matrix W [wires, n, B] u64:
    {"canonicity": k, "range_<bits>": k, "lookup_limb_<bits>": k}, zero
    everywhere for an honest witness.  A value over its bound weighs in with
    its bits above the bound (v >> bits), as in the reference, so one wildly
    corrupt value can count for more than one."""
    W = np.asarray(W)
    out = {"canonicity": int((W >= np.uint64(gl.P)).sum())}
    for gi, gate in enumerate(circuit.gates):
        if not isinstance(gate, RangeLookupGate):
            continue
        rows = circuit.gate_rows[gi]
        lb = gate.limb_bits
        # declared bound on each pooled value (the value wires are cols 0..V-1)
        vals = W[:gate.num_vals][:, rows, :]
        key = f"range_{gate.bits}"
        out[key] = out.get(key, 0) + int((vals >> np.uint64(gate.bits)).sum())
        # derived limbs must sit inside the (scaled) lookup table range
        limb_cols = np.array([gate.wire_limb(v, j) for v in range(gate.num_vals)
                              for j in range(gate.num_limbs)])
        lbad = int((W[limb_cols][:, rows, :] >> np.uint64(lb)).sum())
        if gate.scale > 1:
            top_cols = np.array([gate.wire_limb(v, gate.num_limbs - 1)
                                 for v in range(gate.num_vals)])
            tops = W[top_cols][:, rows, :]
            # scale-check only tops that pass the plain limb bound: a wildly
            # corrupt top could wrap tops * scale in u64 and be missed here
            # (the plain check above has already counted it)
            in_range = tops < np.uint64(1 << lb)
            scaled_bad = (tops * np.uint64(gate.scale) >> np.uint64(lb)) != 0
            lbad += int((in_range & scaled_bad).sum())
        lkey = f"lookup_limb_{gate.bits}"
        out[lkey] = out.get(lkey, 0) + lbad
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
