"""In-circuit gate evaluation in the port (the recursion surface), against
the reference, tolerance 0 (integers).  For every gate of the reference's
tests/test_recursion_surface.py and PoseidonGate: the port's in-circuit
evaluation over random GF(p^2) openings equals the reference's in-circuit
evaluation and the native extension evaluation of both packages.  Also the
recursion presets, the constraint-identity circuit on the demo proof, and
PoseidonGate.eval under the prover's TorchAlgebra against the reference's own
quotient-path (stacked) evaluation of the gate."""

import dataclasses

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.circuit import algebra as ref_algebra
from plonky2_ecdsa_tpu.circuit import builder as ref_builder
from plonky2_ecdsa_tpu.circuit import config as ref_config
from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit import foreign as ref_foreign
from plonky2_ecdsa_tpu.circuit import gates as ref_gates
from plonky2_ecdsa_tpu.circuit import poseidon_gate as ref_pg
from plonky2_ecdsa_tpu.circuit import recursion as ref_recursion
from plonky2_ecdsa_tpu.circuit import recursive_verifier as ref_rv
from plonky2_ecdsa_tpu.circuit import witness as ref_witness
from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch.circuit import builder, config, foreign, gates, recursion, witness
from plonky2_ecdsa_tpu_torch.circuit import poseidon_gate as pg
from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchAlgebra, TorchExtAlgebra
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from test_torch_bridge import same_circuit

P = gl.P


def _gates(g, f, poseidon):
    """The reference test's 13 gates and PoseidonGate, from either package
    (g: its gates module, f: its foreign module)."""
    secp = f.secp256k1_base()
    return [g.ConstantGate(4), g.PublicInputGate(3), g.ArithmeticGate(2), g.BaseSum2Gate(1, 5),
            g.RangeCheckGate(8, 2), g.RangeLookupGate(13, 2), g.MulNonNativeGate(secp),
            g.NonNativeAddGate(secp), g.NonNativeSubGate(secp), g.NonNativeAddManyGate(secp, 3),
            g.BigCmpGate(), g.RandomAccessGate(4, 1), g.RandomAccessGate(3, 1), poseidon]


GATES = list(zip(_gates(gates, foreign, pg.PoseidonGate()),
                 _gates(ref_gates, ref_foreign, ref_pg.PoseidonGate())))


def _in_circuit(pkg, gate, wire_vals, const_vals, pi_vals):
    """The gate's constraints evaluated in-circuit over ExtTarget openings
    (pkg: a package's builder, config, recursion and witness modules):
    (circuit, constraint values as (c0, c1) int pairs)."""
    bld, cfg, rec, wit = pkg
    b = bld.CircuitBuilder(cfg.CircuitConfig.test_config())
    wires_c = [rec.add_virtual_ext(b) for _ in range(len(wire_vals))]
    b.register_input("w", [t for e in wires_c for t in e])
    consts_c = [rec.constant_ext(b, int(c0), int(c1)) for c0, c1 in const_vals]
    ctx = {"pi_vals": [rec.constant_ext(b, int(a), int(c)) for a, c in pi_vals]} if len(pi_vals) else {}
    cons = gate.eval_circuit(b, wires_c, consts_c, ctx)
    for e in cons:
        b.register_public_inputs([e[0], e[1]])
    c = b.build()
    W = c.generate_witness({"w": wire_vals.reshape(1, -1)}, 1)
    pis = c.public_input_values()
    assert wit.check_constraints(c, W, pis) == {}
    return c, [(int(pis[0, 2 * i]), int(pis[0, 2 * i + 1])) for i in range(len(cons))]


@pytest.mark.parametrize("gate,ref_gate", GATES, ids=[g.gate_id() for g, _ in GATES])
def test_eval_circuit_matches_reference_and_native(rng, gate, ref_gate):
    assert gate.gate_id() == ref_gate.gate_id()
    nw = gate.num_wires
    ncst = max(2, getattr(gate, "num_consts", 0))
    wire_vals = rng.integers(0, P, size=(nw, 2), dtype=np.uint64)
    const_vals = rng.integers(0, P, size=(ncst, 2), dtype=np.uint64)
    npis = gate.num_cols if isinstance(gate, gates.PublicInputGate) else 0
    pi_vals = rng.integers(0, P, size=(npis, 2), dtype=np.uint64)

    # the port's native evaluation in the extension algebra, at one point
    alg = TorchExtAlgebra((), "cpu")

    def ext(pair):
        return (gl.const(int(pair[0])), gl.const(int(pair[1])))

    ctx = {"pi_vals": [ext(p) for p in pi_vals]} if npis else {}
    native = [(int(gl.to_u64(e[0])), int(gl.to_u64(e[1])))
              for e in gate.eval(alg, [ext(w) for w in wire_vals], [ext(c) for c in const_vals], ctx)]
    assert len(native) == gate.num_constraints

    # the reference's native evaluation
    ralg = ref_algebra.ExtAlgebra(np, ())

    def rext(pair):
        return (ref_gl.from_int(int(pair[0])), ref_gl.from_int(int(pair[1])))

    rctx = {"pi_vals": [rext(p) for p in pi_vals]} if npis else {}
    ref_native = [(int(ref_gl.to_u64(*e[0])), int(ref_gl.to_u64(*e[1])))
                  for e in ref_gate.eval(ralg, [rext(w) for w in wire_vals],
                                         [rext(c) for c in const_vals], rctx)]
    assert ref_native == native

    c, got = _in_circuit((builder, config, recursion, witness), gate, wire_vals, const_vals,
                         pi_vals)
    rc, ref_got = _in_circuit((ref_builder, ref_config, ref_recursion, ref_witness), ref_gate,
                              wire_vals, const_vals, pi_vals)
    assert got == native and ref_got == native
    assert same_circuit(rc, c) == []


def test_recursion_presets():
    cfg = CircuitConfig.standard_recursion_config()
    assert (cfg.num_wires, cfg.num_routed_wires, cfg.fri.rate_bits, cfg.fri.num_query_rounds) == \
        (136, 80, 3, 28)
    cfg = CircuitConfig.recursion_ecc_config()
    assert (cfg.num_wires, cfg.num_routed_wires, cfg.num_constant_cols, cfg.fri.rate_bits,
            cfg.fri.cap_height, cfg.fri.num_query_rounds, cfg.fri.proof_of_work_bits) == \
        (136, 128, 2, 3, 4, 28, 16)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_config.CircuitConfig.recursion_ecc_config())
    assert pg.PoseidonGate().num_wires <= cfg.num_wires


def test_constraint_identity_in_circuit(monkeypatch):
    """The identity at zeta, in-circuit, from the demo proof: the port's
    verifier inputs equal the reference's; the honest witness passes, the
    public inputs expose the openings and challenges, a tampered opening
    fails."""
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit, "cpu")
    W, pis = small_demo_witness(circuit, 2)
    proof = prover.prove(data, W, pis)
    assert verifier.verify(data, proof)
    monkeypatch.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    rc = ref_examples.small_demo_circuit().build()
    rdata = ref_data_mod.build_circuit_data(rc)
    rproof = ref_prover.prove(rdata, *ref_examples.small_demo_witness(rc, 2))

    inputs = rv.verifier_inputs_from_proof(data, proof)
    rinputs = ref_rv.verifier_inputs_from_proof(rdata, rproof)
    assert sorted(inputs) == sorted(rinputs)
    for k in inputs:
        assert inputs[k].dtype == np.uint64 and np.array_equal(inputs[k], rinputs[k]), k

    vb = builder.CircuitBuilder(CircuitConfig.test_config())
    handles = rv.add_constraint_identity_check(vb, data)
    vc = vb.build()
    rvb = ref_builder.CircuitBuilder(ref_config.CircuitConfig.test_config())
    ref_rv.add_constraint_identity_check(rvb, rdata)
    assert same_circuit(rvb.build(), vc) == []
    assert inputs["open0"].shape[1] == 2 * handles["total"]
    VW = vc.generate_witness(inputs, 2)
    vpis = vc.public_input_values()
    assert witness.check_constraints(vc, VW, vpis) == {}
    want = np.concatenate([inputs[k] for k in ("open0", "open1", "zeta", "alphas", "betas",
                                               "gammas", "lk_alphas", "pis")], axis=1)
    assert np.array_equal(vpis, want)

    bad = {k: np.array(v, copy=True) for k, v in inputs.items()}
    bad["open0"][0, 2] ^= np.uint64(1)
    VW2 = vc.generate_witness(bad, 2)
    assert witness.check_constraints(vc, VW2, vc.public_input_values(), raise_on_fail=False), \
        "tampered opening passed the in-circuit identity"


def test_poseidon_gate_on_the_quotient_path():
    """PoseidonGate.eval under TorchAlgebra on a seeded [B, 64] chunk (what
    the prover's quotient runs) equals the reference's stacked evaluation."""
    B, m = 3, 64
    rng = np.random.default_rng(21)
    gate, ref_gate = pg.PoseidonGate(), ref_pg.PoseidonGate()
    w = rng.integers(0, P, (gate.num_wires, B, m), dtype=np.uint64)
    consts = rng.integers(0, P, (2, B, m), dtype=np.uint64)
    alg = TorchAlgebra((B, m), "cpu")
    cons = gate.eval(alg, [gl.from_u64(x) for x in w], [gl.from_u64(x) for x in consts], {})
    got = gl.to_u64(torch.stack([c.expand(B, m) for c in cons]))
    ralg = ref_algebra.BaseAlgebra(np, (B, m))
    rcons = ref_gate.eval_stacked(ralg, ref_gl.from_u64(w),
                                  [ref_gl.from_u64(x) for x in consts], {})
    assert got.shape == (118, B, m)
    assert np.array_equal(got, ref_gl.to_u64(*rcons))
