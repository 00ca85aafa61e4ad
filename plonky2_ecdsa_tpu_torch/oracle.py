"""The reference's numpy prover, as the oracle the port is held against.

Thin entry points into ``plonky2_ecdsa_tpu``'s host path (numpy only, no JAX)
for checks that run where only the port is driven, such as chip_smoke.py:
the demo circuit and its witness, the reference's numpy ``prove`` (re-exported
as ``numpy_prove``, so that such a check reaches the reference only through
the port), and the numpy wires commitment of an ECDSA batch.
"""

from __future__ import annotations

import numpy as np

from plonky2_ecdsa_tpu.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu.prover import prover as _ref
from plonky2_ecdsa_tpu.prover.prover import prove as numpy_prove  # noqa: F401

from .prover.data import build_circuit_data


def demo(batch: int):
    """(data, W, pis) of the small demo circuit for a seeded batch."""
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    W, pis = small_demo_witness(circuit, batch)
    return data, W, pis


def numpy_wires_cap(system, stmts) -> np.ndarray:
    """Wires-commitment cap [B, C, 4] u64 of an ECDSA batch, by the reference
    (numpy prove_core with stop_after='commit')."""
    ref = system.ref
    W = ref.circuit.generate_witness(ref._inputs(stmts), len(stmts))
    wires, pi, pis = _ref.host_prep(system.data, W, ref.circuit.public_input_values())
    cap = _ref.prove_core(system.data, _ref.Backend(system.data, np), wires, pi, pis, np,
                          stop_after="commit")
    return np.asarray(cap[0], np.uint64) | (np.asarray(cap[1], np.uint64) << np.uint64(32))
