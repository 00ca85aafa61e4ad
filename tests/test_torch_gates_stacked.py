"""The port's stacked constraint evaluation (``Gate.eval_stacked``, what the
prover's quotient calls) against the port's own per-constraint ``eval`` and
the reference's ``eval_stacked`` (numpy, ``BaseAlgebra``), tolerance 0: the
reference test's gates (tests/test_gate_eval.py) and every gate the port's
circuits build, on seeded random values with rows of edge values.  Then
guards on the eager torch ops the stacked forms issue, and a quotient with
one specialised gate's constraints out of order, which the verifier must
reject."""

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.circuit import foreign as ref_foreign
from plonky2_ecdsa_tpu.circuit import gates as ref_gates
from plonky2_ecdsa_tpu.circuit import poseidon_gate as ref_poseidon_gate
from plonky2_ecdsa_tpu.circuit.algebra import BaseAlgebra
from plonky2_ecdsa_tpu_torch.circuit import foreign, gates, poseidon_gate
from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchAlgebra
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from plonky2_ecdsa_tpu_torch.utils.debug import EagerOpCounter, quotient_gate_ops
from test_torch_bridge import pair_to_u64, u64_to_pair

P = gl.P
B, M = 2, 6                       # lanes, domain points
NUM_CONSTS, NUM_PIS = 64, 8
EDGES = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32], np.uint64)

# (class, arguments): a string names a ForeignField constructor of circuit.foreign
REFERENCE_TEST_GATES = [
    ("ArithmeticGate", (20,)), ("BaseSum2Gate", (2, 29)), ("RangeCheckGate", (29, 8)),
    ("RangeCheckGate", (34, 7)), ("MulNonNativeGate", ("secp256k1_base",)),
    ("NonNativeAddGate", ("secp256k1_base",)), ("NonNativeSubGate", ("secp256k1_base",)),
    ("NonNativeAddManyGate", ("secp256k1_base", 4)), ("BigCmpGate", ()),
    ("RandomAccessGate", (4, 4)), ("ConstantGate", (2,)),
]
# standard_ecc_config's secp256k1 ECDSA circuit, in its gate order
SECP256K1_GATES = [
    ("ConstantGate", (32,)), ("MulNonNativeGate", ("secp256k1_base",)), ("BigCmpGate", (2,)),
    ("NonNativeAddGate", ("secp256k1_base", 2)), ("MulNonNativeGate", ("secp256k1_scalar",)),
    ("BaseSum2Gate", (2, 29)), ("ArithmeticGate", (20,)), ("RandomAccessGate", (4, 4)),
    ("NonNativeSubGate", ("secp256k1_base", 2)), ("NonNativeSubGate", ("secp256k1_scalar", 2)),
    ("NonNativeAddGate", ("secp256k1_scalar", 2)), ("NonNativeAddManyGate", ("secp256k1_base", 4)),
    ("RangeLookupGate", (29, 28, 13)), ("RangeLookupGate", (34, 28, 13)),
    ("PublicInputGate", (8,)),
]
# p256_ecc_config's P-256 circuit: the gates not in the list above
P256_GATES = [
    ("ConstantGate", (64,)), ("MulNonNativeGate", ("p256_base",)),
    ("MulNonNativeGate", ("p256_scalar",)), ("NonNativeAddGate", ("p256_base", 2)),
    ("NonNativeSubGate", ("p256_base", 2)), ("NonNativeAddManyGate", ("p256_base", 4)),
    ("RangeLookupGate", (29, 31, 13)), ("RangeLookupGate", (34, 31, 13)),
]
# recursion_ecc_config's verifier circuit (the outer proof): the gates not above
OUTER_GATES = [("ArithmeticGate", (32,)), ("BaseSum2Gate", (4, 32)), ("PoseidonGate", ())]
# RandomAccess without the split at the top bit
OTHER_BRANCHES = [("RandomAccessGate", (3, 2))]

SPECS = REFERENCE_TEST_GATES + [s for s in SECP256K1_GATES + P256_GATES + OUTER_GATES
                                + OTHER_BRANCHES if s not in REFERENCE_TEST_GATES]
# the per-constraint ops of standard_ecc_config's gate section, one domain
# chunk, before the quotient called eval_stacked (gate.eval and torch.stack)
SECP256K1_PER_CONSTRAINT_OPS = 62_649


def _make(spec, gates_mod, poseidon_mod, foreign_mod):
    cls, args = spec
    mod = poseidon_mod if cls == "PoseidonGate" else gates_mod
    return getattr(mod, cls)(*[getattr(foreign_mod, a)() if isinstance(a, str) else a
                               for a in args])


def port_gate(spec):
    return _make(spec, gates, poseidon_gate, foreign)


def _spec_id(spec):
    return port_gate(spec).gate_id()


def _field(rng, *shape):
    """Seeded canonical values; the first points of lane 0 (and, rotated, of
    lane 1) of every row walk through EDGES, each row from another start."""
    x = rng.integers(0, P, shape, dtype=np.uint64)
    k = len(EDGES)
    for i in range(shape[0]):
        if len(shape) == 3:
            x[i, 0, :k] = np.roll(EDGES, i)
            x[i, 1, :k] = np.roll(EDGES, 2 * i + 1)
        else:
            x[i, :k] = np.roll(EDGES, i)
    return x


def _inputs(gate, seed):
    rng = np.random.default_rng(seed)
    return (_field(rng, gate.num_wires, B, M), _field(rng, NUM_CONSTS, M),
            _field(rng, NUM_PIS, B, M))


def _port_args(w, consts, pis):
    """The quotient's calling convention: the wires a strided view of a
    [B, wires, M] tensor, the constant columns [1, M] each, the PIs [B, M]."""
    W = gl.from_u64(np.concatenate([w, w[:3]]).transpose(1, 0, 2))     # [B, wires + 3, M]
    return (TorchAlgebra((B, M), "cpu"), W[:, :w.shape[0]].movedim(1, 0),
            list(gl.from_u64(consts)[:, None].unbind(0)),
            {"pi_vals": list(gl.from_u64(pis).unbind(0))})


def _port_eval(gate, w, consts, pis, stacked=True):
    alg, warr, cs, ctx = _port_args(w, consts, pis)
    if stacked:
        return gate.eval_stacked(alg, warr, cs, ctx)
    return torch.stack([v.expand(B, M) for v in gate.eval(alg, list(warr.unbind(0)), cs, ctx)])


def _reference_eval(spec, w, consts, pis):
    gate = _make(spec, ref_gates, ref_poseidon_gate, ref_foreign)
    cs = [u64_to_pair(np.broadcast_to(c, (B, M))) for c in consts]
    got = gate.eval_stacked(BaseAlgebra(np, (B, M)), u64_to_pair(w), cs,
                            {"pi_vals": [u64_to_pair(p) for p in pis]})
    return pair_to_u64(got)


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_eval_stacked_matches_eval_and_reference(spec):
    gate = port_gate(spec)
    w, consts, pis = _inputs(gate, seed=gate.num_wires)
    got = _port_eval(gate, w, consts, pis)
    assert got.shape == (gate.num_constraints, B, M)
    assert torch.equal(got, _port_eval(gate, w, consts, pis, stacked=False))
    want = _reference_eval(spec, w, consts, pis)
    assert np.array_equal(gl.to_u64(got), want)
    if gate.num_wires > 12:
        # honest-looking small wire values (bits, carries) next to the random ones
        small = np.random.default_rng(1).integers(0, 3, w.shape).astype(np.uint64)
        got = _port_eval(gate, small, consts, pis)
        assert np.array_equal(gl.to_u64(got), _reference_eval(spec, small, consts, pis))


SPECIALISED = [s for s in SPECS
               if type(port_gate(s)).eval_stacked is not gates.Gate.eval_stacked]


def test_the_eleven_classes_are_specialised():
    assert {s[0] for s in SPECIALISED} == {
        "ArithmeticGate", "BaseSum2Gate", "RangeCheckGate", "MulNonNativeGate",
        "ConstantGate", "PublicInputGate", "NonNativeAddGate", "NonNativeSubGate",
        "NonNativeAddManyGate", "BigCmpGate", "RandomAccessGate"}


def _ops(fn):
    fn()                          # the gates' constants are made on the first call
    with EagerOpCounter() as counter:
        fn()
    return counter.count


@pytest.mark.parametrize("spec", SPECIALISED, ids=_spec_id)
def test_stacked_form_issues_under_half_the_ops(spec):
    gate = port_gate(spec)
    args = _port_args(*_inputs(gate, seed=0))
    stacked = _ops(lambda: gate.eval_stacked(*args))
    default = _ops(lambda: gates.Gate.eval_stacked(gate, *args))
    assert 2 * stacked < default, (stacked, default)


def test_secp256k1_gate_section_under_a_third(monkeypatch):
    """The quotient's gate section (eval_stacked and the alpha-weighting) for
    one domain chunk of the secp256k1 circuit: under a third of what the
    per-constraint forms issued."""
    gs = [port_gate(s) for s in SECP256K1_GATES]
    stacked = quotient_gate_ops(gs, num_consts=32, challenges=2)
    for cls in {type(g) for g in gs}:
        monkeypatch.setattr(cls, "eval_stacked", gates.Gate.eval_stacked)
    per_constraint = quotient_gate_ops(gs, num_consts=32, challenges=2)
    assert 3 * stacked < SECP256K1_PER_CONSTRAINT_OPS <= per_constraint, (stacked, per_constraint)


def test_quotient_with_constraints_out_of_order_is_rejected(monkeypatch):
    """BaseSum2's first two constraints swapped in the quotient only: every
    constraint still vanishes on H, but the alpha slots weight the wrong
    ones, so the opened quotient misses the verifier's constraint identity
    (the verifier evaluates gate.eval)."""
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, batch=2)
    assert verifier.verify(data, prover.prove(data, W, pis))
    stacked = gates.BaseSum2Gate.eval_stacked

    def swapped(self, alg, warr, consts, ctx):
        return stacked(self, alg, warr, consts, ctx)[[1, 0] + list(range(2, self.num_constraints))]

    monkeypatch.setattr(gates.BaseSum2Gate, "eval_stacked", swapped)
    with pytest.raises(verifier.VerifyError, match="constraint identity fails"):
        verifier.verify_strict(data, prover.prove(data, W, pis))
