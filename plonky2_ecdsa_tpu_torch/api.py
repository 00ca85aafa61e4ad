"""Batched ECDSA proving on PyTorch: build once, prove many.

Counterpart of ``plonky2_ecdsa_tpu.api``: the verify circuit is built once per
curve, the fixed data is committed once on the chosen device, and whole
signature batches go through the tensor prover, one batch lane per
statement.  Everything here is this package's own: circuit, gadgets, witness
tape, prover and verifier.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import trace
from .circuit.builder import CircuitBuilder
from .circuit.config import CircuitConfig
from .circuit.foreign import BITS, base_field, scalar_field
from .circuit.witness import check_constraints
from .curve import native as cn
from .curve.native import P256, SECP256K1  # noqa: F401
from .gadgets import ecdsa as ge
from .gadgets import nonnative as gn
from .gadgets.curve import AffinePointTarget
from .prover.data import CircuitData, build_circuit_data
from .prover.prover import Proof, Prover
from .prover.verifier import verify, verify_one_exact  # noqa: F401
from .utils.debug import gate_histogram

MASK = (1 << BITS) - 1
CURVES = {"secp256k1": cn.SECP256K1, "p256": cn.P256}    # by the command line's names


def int_to_limbs(vals, num_limbs: int = 9) -> np.ndarray:
    """[B] Python ints -> [B, num_limbs] uint64 rows of 29-bit limbs."""
    out = np.zeros((len(vals), num_limbs), np.uint64)
    for i, v in enumerate(vals):
        v = int(v)
        for j in range(num_limbs):
            out[i, j] = (v >> (BITS * j)) & MASK
    return out


def limbs_to_int(arr) -> list:
    """[B, num_limbs] rows of 29-bit limbs -> [B] Python ints."""
    return [sum(int(limb) << (BITS * j) for j, limb in enumerate(row)) for row in arr]


@dataclass
class EcdsaStatement:
    """One signature-verification instance (native ints)."""
    msg: int
    r: int
    s: int
    pk: cn.Point


class EcdsaProverSystem:
    """The ECDSA-verify circuit for one curve and config, proved and verified
    on `device`.  Without a config, P-256 takes p256_ecc_config and secp256k1
    standard_ecc_config.  `build_seconds` is the circuit build's time (the
    trace span "setup.circuit_build"); with `verbose` it is printed with the
    row count and n.

    Public inputs, in order: pk.x, pk.y, msg, r, s (45 limbs of 29 bits), so a
    proof binds the statement "signature (r, s) on msg verifies under pk"."""

    def __init__(self, curve: cn.CurveParams = cn.SECP256K1,
                 config: CircuitConfig | None = None, device="cuda", verbose: bool = False):
        self.curve = curve
        self.device = device
        with trace.span("setup.circuit_build") as build:
            b = self._builder(curve, config)
            self.circuit = b.build()
        self.build_seconds = build.seconds
        if verbose:
            print(f"[api] {curve.name} circuit: {len(b.rows)} rows -> n={self.circuit.n} "
                  f"({self.build_seconds:.1f}s build)")
        self._data: CircuitData | None = None
        self._prover: Prover | None = None

    @staticmethod
    def _builder(curve: cn.CurveParams, config: CircuitConfig | None) -> CircuitBuilder:
        """The verify circuit's builder, every constraint added."""
        if config is None:
            config = (CircuitConfig.p256_ecc_config() if curve is cn.P256
                      else CircuitConfig.standard_ecc_config())
        b = CircuitBuilder(config)
        sf = scalar_field(curve)
        msg = gn.add_virtual_nonnative(b, sf)
        r = gn.add_virtual_nonnative(b, sf)
        s = gn.add_virtual_nonnative(b, sf)
        bf = base_field(curve)
        pk = AffinePointTarget(curve, gn.add_virtual_nonnative(b, bf),
                               gn.add_virtual_nonnative(b, bf))
        for name, t in [("msg", msg), ("r", r), ("s", s)]:
            b.register_input(name, t.limbs)
        b.register_input("pk_x", pk.x.limbs)
        b.register_input("pk_y", pk.y.limbs)
        for t in (pk.x, pk.y, msg, r, s):
            b.register_public_inputs(t.limbs)
        sig = ge.ECDSASignatureTarget(r=r, s=s)
        pkt = ge.ECDSAPublicKeyTarget(point=pk)
        if curve is cn.SECP256K1:
            ge.verify_secp256k1_message_circuit(b, msg, sig, pkt)
        elif curve is cn.P256:
            ge.verify_p256_message_circuit(b, msg, sig, pkt)
        else:
            raise ValueError(f"unsupported curve {curve.name}")
        return b

    # ------------------------------------------------------------------ stats
    @property
    def num_rows(self) -> int:
        return int((self.circuit.row_gate_idx >= 0).sum())

    @property
    def n(self) -> int:
        return self.circuit.n

    def gate_counts(self) -> dict:
        """Rows per gate type."""
        return gate_histogram(self.circuit)

    # ------------------------------------------------------------- fixed data
    @property
    def data(self) -> CircuitData:
        """The fixed data, committed on the device at first use."""
        if self._data is None:
            self._data = build_circuit_data(self.circuit, self.device)
        return self._data

    @property
    def prover(self) -> Prover:
        if self._prover is None:
            self._prover = Prover(self.data)
        return self._prover

    # --------------------------------------------------------------- witness
    def _inputs(self, stmts) -> dict:
        return {
            "msg": int_to_limbs([st.msg for st in stmts]),
            "r": int_to_limbs([st.r for st in stmts]),
            "s": int_to_limbs([st.s for st in stmts]),
            "pk_x": int_to_limbs([st.pk.x for st in stmts]),
            "pk_y": int_to_limbs([st.pk.y for st in stmts]),
        }

    def witness(self, stmts):
        """The witness matrix [num_wires, n, B] u64 and the PIs [B, 45]."""
        W = self.circuit.generate_witness(self._inputs(stmts), len(stmts))
        return W, self.circuit.public_input_values()

    def witness_vals(self, stmts):
        """The witness as the tape's value table [T, B] u64 (what
        Prover.run_vals takes), and the PIs [B, 45]."""
        with trace.span("witness.inputs"):
            inputs = self._inputs(stmts)
        vals = self.circuit.value_table(inputs, len(stmts))
        return vals, self.circuit.public_input_values()

    def check(self, stmts) -> bool:
        """True when the statements' witness satisfies every gate constraint
        (on the host, no proof); raises AssertionError naming the first
        violated constraint otherwise."""
        W, pis = self.witness(stmts)
        return check_constraints(self.circuit, W, pis) == {}

    # ---------------------------------------------------------- prove, verify
    def prove(self, stmts) -> Proof:
        """One proof with a batch lane per statement."""
        return self.prover.run_vals(*self.witness_vals(stmts))

    def verify(self, proof: Proof) -> bool:
        return verify(self.data, proof)

    def verify_statement(self, proof: Proof, i: int, stmt: EcdsaStatement) -> bool:
        """verify() and lane i's public inputs bind the given statement."""
        return verify(self.data, proof) and bool(np.array_equal(proof.pis[i],
                                                                statement_pis(stmt)))


def statement_pis(stmt: EcdsaStatement) -> np.ndarray:
    """The 45 public-input limbs that bind a proof lane to `stmt`."""
    return np.concatenate([int_to_limbs([v])[0] for v in
                           (stmt.pk.x, stmt.pk.y, stmt.msg, stmt.r, stmt.s)])


def random_statements(curve: cn.CurveParams, count: int, seed: int = 0) -> list:
    """`count` valid statements from numpy's default_rng(seed): keys, messages
    and nonces drawn 40 bytes at a time, signed by the native curve layer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        sk = int.from_bytes(rng.bytes(40), "little") % curve.n or 1
        msg = int.from_bytes(rng.bytes(40), "little") % curve.n
        nonce = int.from_bytes(rng.bytes(40), "little") % curve.n or 1
        _, pk = cn.keygen(curve, sk)
        r, s = cn.sign_message(curve, msg, sk, nonce)
        assert cn.verify_message(curve, msg, r, s, pk)
        out.append(EcdsaStatement(msg=msg, r=r, s=s, pk=pk))
    return out


def prove_ecdsa_batch(system: EcdsaProverSystem, stmts) -> Proof:
    """One proof object with a batch lane per signature."""
    return system.prove(stmts)
