"""Batched ECDSA proving on PyTorch: build once, prove many.

Counterpart of ``plonky2_ecdsa_tpu.api.EcdsaProverSystem``.  The circuit, the
witness tape and the fixed data are the reference's host code; ``prove``
runs the port's prover on the chosen device, and ``verify`` /
``verify_statement`` run the reference's numpy verifier.
"""

from __future__ import annotations

from plonky2_ecdsa_tpu import api as _ref
from plonky2_ecdsa_tpu.curve.native import SECP256K1
from plonky2_ecdsa_tpu.prover.verifier import verify, verify_one_exact  # noqa: F401

from .prover.data import build_circuit_data
from .prover.prover import Proof, make_prover

EcdsaStatement = _ref.EcdsaStatement
random_statements = _ref.random_statements


class EcdsaProverSystem:
    """The ECDSA-verify circuit for one curve, proved on `device`."""

    def __init__(self, curve=SECP256K1, device="cuda"):
        self.ref = _ref.EcdsaProverSystem(curve)
        self.circuit = self.ref.circuit
        self.device = device
        self._prover = None

    @property
    def data(self):
        """The reference's CircuitData (host build, made on first use)."""
        if self.ref._data is None:
            self.ref._data = build_circuit_data(self.circuit)
        return self.ref.data

    @property
    def prover(self):
        """The port's prover for this circuit (fixed data on the device)."""
        if self._prover is None:
            self._prover = make_prover(self.data, self.device)
        return self._prover

    def witness_vals(self, stmts):
        """Witness as the tape's value table [T, B] u64, and the PIs [B, 45]."""
        return self.ref.witness_vals(stmts)

    def prove(self, stmts) -> Proof:
        """One proof with a batch lane per statement."""
        return self.prover.run_vals(*self.witness_vals(stmts))

    def verify(self, proof: Proof) -> bool:
        self.data  # the JAX-free build, before the reference reads it
        return self.ref.verify(proof)

    def verify_statement(self, proof: Proof, i: int, stmt) -> bool:
        """verify() and lane i's public inputs bind the given statement."""
        self.data
        return self.ref.verify_statement(proof, i, stmt)
