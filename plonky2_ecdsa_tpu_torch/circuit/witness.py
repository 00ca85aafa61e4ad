"""Host-side field helpers on uint64 arrays and the witness constraint checker.

Counterpart of ``plonky2_ecdsa_tpu.circuit.witness``.  The tape (builder.py)
computes witness values on the host in numpy; the ``g*`` helpers are the host
field of ``fields.goldilocks_host`` under the names the gadgets use.
``check_constraints`` evaluates every gate's constraints over the full
witness matrix: the fast correctness check for circuits too large to prove
in a unit test.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks_host as gl
from .algebra import BaseAlgebra
from .gates import PublicInputGate

P = gl.P

gadd = gl.add
gsub = gl.sub
gneg = gl.neg
gmul = gl.mul
gmul_const = gl.mul_const
ginv = gl.inverse
gpow = gl.pow_const


# ---------------------------------------------------------------------------
# Constraint checking over the witness matrix
# ---------------------------------------------------------------------------

def check_constraints(circuit, W: np.ndarray, pi_values: np.ndarray | None = None,
                      raise_on_fail: bool = True):
    """Evaluate all gate constraints on all rows.

    W: [num_wires, n, B] uint64.  Returns dict gate_id -> max abs violation
    count; raises AssertionError on any nonzero constraint if raise_on_fail.
    """
    failures = {}
    alg = BaseAlgebra()
    for gi, gate in enumerate(circuit.gates):
        rows = circuit.gate_rows.get(gi, np.array([], dtype=np.int64))
        if len(rows) == 0 or gate.num_constraints == 0:
            continue
        wires_u64 = W[:, rows, :]  # [num_wires, R, B]
        wires = [wires_u64[c] for c in range(gate.num_wires)]
        consts = [np.broadcast_to(circuit.constants[j, rows][:, None],
                                  wires_u64.shape[1:]).copy()
                  for j in range(circuit.config.num_constant_cols)]
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = _pi_vals_for_rows(circuit, rows, pi_values, wires_u64.shape[1:])
        cons = gate.eval(alg, wires, consts, ctx)
        bad = 0
        for ci, c in enumerate(cons):
            v = np.broadcast_to(c, wires_u64.shape[1:])
            nz = int(np.count_nonzero(v))
            if nz:
                bad += nz
                if raise_on_fail:
                    idx = np.argwhere(v != 0)[0]
                    raise AssertionError(
                        f"constraint {ci} of {gate.gate_id()} violated at "
                        f"row={rows[idx[0]]} batch={idx[1]}: value {v[tuple(idx)]}"
                    )
        if bad:
            failures[gate.gate_id()] = bad
    return failures


def _pi_vals_for_rows(circuit, rows, pi_values, shape):
    """Per-row public-input column values for the PI gate rows.

    pi_values: [B, num_pis] (from circuit.public_input_values())."""
    K = circuit.pi.num_cols
    B = shape[-1]
    out = np.zeros((K,) + tuple(shape), dtype=np.uint64)
    if pi_values is not None:
        row_index = {r: i for i, r in enumerate(circuit.pi.rows)}
        for ri, r in enumerate(rows):
            blk = row_index.get(int(r))
            if blk is None:
                continue
            for j in range(K):
                pi_idx = blk * K + j
                if pi_idx < circuit.pi.count:
                    out[j, ri, :] = pi_values[:, pi_idx]
    return [out[j] for j in range(K)]
