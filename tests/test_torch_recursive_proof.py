"""Recursion in the port against the reference, on the CPU, tolerance 0
throughout (integers): the PoseidonGate gadget and the C++ tape op that
fills it, the demo verifier circuit (structure and value table at B=2), a
tampered inner proof breaking the outer witness, and the aggregation level-1
circuit with its inputs.  Slow: the whole demo outer proof leaf for leaf
with both verifiers, and the 4-to-1 aggregation fold.

The demo setting (inner circuit, configs, seeds) is the reference's
tests/test_recursive_proof.py, written once in the port's circuit.examples;
the helpers below build it with either package's builder, and
tests/test_torch_anchors.py freezes it for the GPU."""

import copy

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.circuit import builder as ref_builder
from plonky2_ecdsa_tpu.circuit import config as ref_config
from plonky2_ecdsa_tpu.circuit import poseidon_gate as ref_pg
from plonky2_ecdsa_tpu.circuit import recursive_verifier as ref_rv
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover import verifier as ref_verifier
from plonky2_ecdsa_tpu_torch.circuit import builder, config, examples
from plonky2_ecdsa_tpu_torch.circuit import poseidon_gate as pg
from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
from plonky2_ecdsa_tpu_torch.circuit.witness import check_constraints
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import poseidon
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from test_torch_bridge import (from_reference_proof, same_circuit, to_reference_config,
                               to_reference_proof)

P = gl.P
DEMO_BATCH, DEMO_SEED, AGG_BATCH, AGG_SEED = 2, 77, 4, 99
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the demo setting (circuit.examples), through either package's builder
# ---------------------------------------------------------------------------

INNER, OUTER, AGG = examples.recursion_demo_configs()


def port_inner(batch: int, seed: int):
    """(inner circuit, its data on the CPU, its proof) in the port."""
    ic = examples.recursion_demo_inner()
    W = ic.generate_witness(examples.recursion_demo_inputs(batch, seed), batch)
    idata = build_circuit_data(ic, "cpu")
    return ic, idata, prover.prove(idata, W, ic.public_input_values())


def ref_inner_circuit():
    """The demo inner circuit built by the reference's builder."""
    return examples.recursion_demo_inner(ref_builder.CircuitBuilder(to_reference_config(INNER)))


def ref_inner(batch: int, seed: int, monkeypatch):
    """The same in the reference's numpy path."""
    ic = ref_inner_circuit()
    W = ic.generate_witness(examples.recursion_demo_inputs(batch, seed), batch)
    idata = ref_numpy_data(ic, monkeypatch)
    return ic, idata, ref_prover.prove(idata, W, ic.public_input_values())


def ref_numpy_data(circuit, monkeypatch):
    """The reference's CircuitData through its numpy fixed commit."""
    monkeypatch.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    return ref_data_mod.build_circuit_data(circuit)


def ref_outer_circuit(idata, conf=OUTER):
    """The reference's verifier circuit of `idata` under the port's config `conf`."""
    ob = ref_builder.CircuitBuilder(to_reference_config(conf))
    ref_rv.build_recursive_verifier(ob, idata)
    return ob.build()


def permute_circuit(bld, cfg, rounds: int = 1, conf=None):
    b = bld.CircuitBuilder(conf or cfg.CircuitConfig.standard_recursion_config())
    ins = b.add_virtual_targets(12)
    b.register_input("state", ins)
    outs = ins
    perm = pg.poseidon_permute if bld is builder else ref_pg.poseidon_permute
    for _ in range(rounds):
        outs = perm(b, outs)
    b.register_public_inputs(outs)
    return b.build()


@pytest.fixture(scope="module")
def demo():
    """The port's demo inner proof and outer circuit with its value table."""
    ic, idata, iproof = port_inner(DEMO_BATCH, DEMO_SEED)
    oc = rv.verifier_circuit(idata, OUTER)
    vals = oc.value_table(rv.recursive_verifier_inputs(idata, iproof), DEMO_BATCH).copy()
    return ic, idata, iproof, oc, vals


@pytest.fixture(scope="module")
def ref_demo():
    with pytest.MonkeyPatch.context() as mp:
        ic, idata, iproof = ref_inner(DEMO_BATCH, DEMO_SEED, mp)
    return ic, idata, iproof, ref_outer_circuit(idata)


# ---------------------------------------------------------------------------
# PoseidonGate
# ---------------------------------------------------------------------------

def test_poseidon_tables_reproduce_the_permutation():
    """ME, MI and the round constants, applied as the gate's trace does, give
    permute_plain on every basis vector, on zero and on random states; ME is
    hash/poseidon.py's external layer column by column."""
    rng = np.random.default_rng(4)
    states = np.concatenate([np.eye(12, dtype=np.uint64), np.zeros((1, 12), np.uint64),
                             rng.integers(0, P, (5, 12), dtype=np.uint64)])
    outs, _stored = pg._host_permute_trace([states[:, i] for i in range(12)])
    want = gl.to_u64(poseidon.permute_plain(gl.from_u64(states.T.copy())))
    assert np.array_equal(np.stack(outs), want)
    ext = gl.to_u64(poseidon._ext_layer(gl.from_u64(np.eye(12, dtype=np.uint64))))
    assert np.array_equal(ext, np.array(pg.ME, np.uint64))      # column j = ME e_j
    assert (pg.ME, pg.MI, pg.RC) == (ref_pg._ME, ref_pg._MI, ref_pg._RC)


def test_poseidon_permute_matches_plain_and_reference():
    """Two chained gadget rows: the outputs equal permute_plain twice; the
    circuit and the value table equal the reference's gadget; the witness
    satisfies the constraints."""
    c, rc = permute_circuit(builder, config, 2), permute_circuit(ref_builder, ref_config, 2)
    assert same_circuit(rc, c) == []
    B = 3
    sv = np.random.default_rng(1).integers(0, P, (B, 12), dtype=np.uint64)
    W = c.generate_witness({"state": sv}, B)
    pis = c.public_input_values()
    want = poseidon.permute_plain(poseidon.permute_plain(gl.from_u64(sv.T.copy())))
    assert np.array_equal(pis, gl.to_u64(want).T)
    assert np.array_equal(c._last_vals, rc._run_tape({"state": sv}, B, None))
    check_constraints(c, W, pis)
    gate = next(g for g in c.gates if g.gate_id() == "Poseidon")
    assert (gate.num_wires, gate.num_constraints, gate.degree) == (130, 118, 7)


@pytest.mark.parametrize("states", ["random", "edges"])
def test_native_poseidon_op_equals_numpy_closure(states):
    """The C++ `poseidon` tape op and the numpy closure give identical value
    tables: 1000 seeded states, and states of edge words."""
    c = permute_circuit(builder, config, 2)
    if states == "random":
        sv = np.random.default_rng(1000).integers(0, P, (1000, 12), dtype=np.uint64)
    else:
        edges = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - 2, (1 << 63)], np.uint64)
        rng = np.random.default_rng(5)
        sv = np.concatenate([np.repeat(edges[:, None], 12, 1),
                             rng.choice(edges, (200, 12))])
    native = c.value_table({"state": sv}, len(sv), native=True).copy()
    plain = c.value_table({"state": sv}, len(sv), native=False).copy()
    assert c._native_tape().n_native == 2
    assert np.array_equal(native, plain)


def test_flipped_stored_wire_fails_the_constraints():
    c = permute_circuit(builder, config)
    W = c.generate_witness({"state": np.arange(24, dtype=np.uint64).reshape(2, 12)}, 2)
    pis = c.public_input_values()
    check_constraints(c, W, pis)
    gate = next(g for g in c.gates if g.gate_id() == "Poseidon")
    row = c.gate_rows[c.gates.index(gate)][0]
    for wire in (gate.wire_full_a(2, 3), gate.wire_partial(5), gate.wire_full_b(28, 11)):
        bad = W.copy()
        bad[wire, row, 1] ^= np.uint64(1)
        with pytest.raises(AssertionError, match="of Poseidon violated"):
            check_constraints(c, bad, pis)


def test_degree_7_gate_under_rate_4_is_rejected():
    conf = config.CircuitConfig(num_wires=136, num_routed_wires=80, num_constant_cols=2,
                                range_lookup_limb_bits=3,
                                fri=config.FriConfig(rate_bits=2, cap_height=1,
                                                     num_query_rounds=4, proof_of_work_bits=0))
    c = permute_circuit(builder, config, conf=conf)
    with pytest.raises(ValueError, match="degree 7 > blowup"):
        build_circuit_data(c, "cpu")


# ---------------------------------------------------------------------------
# the demo verifier circuit
# ---------------------------------------------------------------------------

def test_demo_outer_circuit_and_table_equal_the_reference(demo, ref_demo):
    ic, idata, iproof, oc, vals = demo
    ric, ridata, riproof, roc = ref_demo
    assert same_circuit(ric, ic) == []
    assert prover.first_difference(from_reference_proof(riproof), iproof) is None
    assert same_circuit(roc, oc) == []
    counts = {g.gate_id(): len(oc.gate_rows.get(gi, ())) for gi, g in enumerate(oc.gates)}
    assert counts["Poseidon"] > 100
    inputs = rv.recursive_verifier_inputs(idata, iproof)
    rinputs = ref_rv.recursive_verifier_inputs(ridata, riproof)
    assert sorted(inputs) == sorted(rinputs)
    for k in inputs:
        assert np.array_equal(inputs[k], rinputs[k]), k
    assert np.array_equal(vals, roc._run_tape(rinputs, DEMO_BATCH, None))
    assert np.array_equal(oc.public_input_values(), iproof.pis)   # inner PIs re-exported
    check_constraints(oc, oc.generate_witness(inputs, DEMO_BATCH), iproof.pis)


@pytest.mark.parametrize("where", ["opening", "statement", "pow_witness"])
def test_tampered_inner_proof_breaks_the_outer_witness(demo, where):
    _ic, idata, iproof, oc, _vals = demo
    bad = copy.deepcopy(iproof)
    if where == "opening":
        bad.openings0[0][0, 3] ^= np.uint64(1)
    elif where == "statement":
        bad.pis[1, 0] ^= np.uint64(1)
    else:
        bad.fri_proof.pow_witness[0] ^= np.uint64(1)
    Wb = oc.generate_witness(rv.recursive_verifier_inputs(idata, bad), DEMO_BATCH)
    fails = check_constraints(oc, Wb, oc.public_input_values(), raise_on_fail=False)
    assert fails, "a tampered inner proof still satisfies the outer circuit"


def test_aggregation_level1_equals_the_reference(monkeypatch):
    """The 2-to-1 circuit, split_proof_lanes and aggregation_inputs."""
    ic, idata, iproof = port_inner(AGG_BATCH, AGG_SEED)
    ric, ridata, riproof = ref_inner(AGG_BATCH, AGG_SEED, monkeypatch)
    assert prover.first_difference(from_reference_proof(riproof), iproof) is None
    ab = builder.CircuitBuilder(AGG)
    layouts = rv.build_aggregation_verifier(ab, idata)
    rab = ref_builder.CircuitBuilder(to_reference_config(AGG))
    assert layouts == ref_rv.build_aggregation_verifier(rab, ridata)
    ac, rac = ab.build(), rab.build()
    assert same_circuit(rac, ac) == []
    halves = rv.split_proof_lanes(iproof)
    rhalves = ref_rv.split_proof_lanes(riproof)
    for h, rh in zip(halves, rhalves):
        assert prover.first_difference(from_reference_proof(rh), h) is None
        assert h.layout == iproof.layout
    assert [h.pis.tolist() for h in halves] == [iproof.pis[0::2].tolist(), iproof.pis[1::2].tolist()]
    inputs = rv.aggregation_inputs(idata, halves)
    rinputs = ref_rv.aggregation_inputs(ridata, rhalves)
    assert sorted(inputs) == sorted(rinputs) and all(
        np.array_equal(inputs[k], rinputs[k]) for k in inputs)
    ac.generate_witness(inputs, AGG_BATCH // 2)
    want = np.concatenate([iproof.pis[0::2], iproof.pis[1::2]], axis=1)
    assert np.array_equal(ac.public_input_values(), want)


# ---------------------------------------------------------------------------
# whole proofs (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_demo_outer_proof_equals_the_reference(demo, ref_demo, monkeypatch):
    """The outer proof, leaf for leaf; each verifier accepts the other's
    proof; lane 0 through the exact verifier."""
    _ic, _idata, iproof, oc, vals = demo
    _ric, _ridata, _riproof, roc = ref_demo
    odata = build_circuit_data(oc, "cpu")
    oproof = prover.Prover(odata).run_vals(vals, oc.public_input_values())
    rodata = ref_numpy_data(roc, monkeypatch)
    rW = roc.generate_witness(ref_rv.recursive_verifier_inputs(_ridata, _riproof), DEMO_BATCH)
    rproof = ref_prover.prove(rodata, rW, roc.public_input_values())
    assert prover.first_difference(from_reference_proof(rproof), oproof) is None
    assert verifier.verify(odata, from_reference_proof(rproof))
    assert ref_verifier.verify(rodata, to_reference_proof(oproof))
    assert verifier.verify_one_exact(odata, oproof, 0)
    bad = copy.deepcopy(oproof)
    bad.openings0[1][1, 7] ^= np.uint64(1)
    assert not verifier.verify(odata, bad)


@pytest.mark.slow
def test_aggregation_tree_4_to_1():
    """4 demo proofs -> 2 -> 1: the root proof verifies and its PIs are the
    four statements' PIs in lane order; a flipped leaf statement breaks the
    level-1 witness."""
    ic, idata, iproof = port_inner(AGG_BATCH, AGG_SEED)
    ipis = iproof.pis
    ac = rv.verifier_circuit(idata, AGG, aggregate=True)
    adata = build_circuit_data(ac, "cpu")
    vals = ac.value_table(rv.aggregation_inputs(idata, rv.split_proof_lanes(iproof)), 2)
    apis = ac.public_input_values()
    aproof = prover.Prover(adata).run_vals(vals, apis)
    assert verifier.verify(adata, aproof)
    ac2 = rv.verifier_circuit(adata, AGG, aggregate=True)
    adata2 = build_circuit_data(ac2, "cpu")
    vals2 = ac2.value_table(rv.aggregation_inputs(adata, rv.split_proof_lanes(aproof)), 1)
    apis2 = ac2.public_input_values()
    assert np.array_equal(apis2[0].reshape(AGG_BATCH, ipis.shape[1]), ipis)
    root = prover.Prover(adata2).run_vals(vals2, apis2)
    assert verifier.verify(adata2, root)
    bad = copy.deepcopy(iproof)
    bad.pis[2, 0] ^= np.uint64(1)
    Wb = ac.generate_witness(rv.aggregation_inputs(idata, rv.split_proof_lanes(bad)), 2)
    assert check_constraints(ac, Wb, ac.public_input_values(), raise_on_fail=False)
