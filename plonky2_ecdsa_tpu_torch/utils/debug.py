"""Witness sanitizer: range checks over a whole witness batch, on numpy.

Counterpart of ``plonky2_ecdsa_tpu.utils.debug``.  ``witness_violations``
validates a witness matrix against the contracts the proof system ASSUMES of
an honest witness:

  * canonicity   every wire value < Goldilocks p;
  * range pools  every pooled range-checked value (29-bit limbs, 34-bit
                 nonnative-mul carries) within its declared bound, and every
                 derived lookup limb within the scaled table bound.

A violation means a fault in a witness generator: the proof would fail
anyway, but with an opaque quotient or lookup mismatch; this reports counts
per class instead.
"""

from __future__ import annotations

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
