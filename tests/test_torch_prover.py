"""Whole proofs: the port's own circuit, witness, fixed data and prover
against the reference's numpy prove, leaf for leaf (tolerance 0), on the demo
and nonnative-mul circuits; the production run_vals path against the
full-witness path; a value of 2^40 and more going up whole; and the loud
failures (exhausted grind, tampered proof)."""

import dataclasses

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover.verifier import verify as ref_verify
from plonky2_ecdsa_tpu_torch import trace
from plonky2_ecdsa_tpu_torch.api import int_to_limbs
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import (nonnative_mul_chain_circuit,
                                                      small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.challenger import GRIND_EXHAUSTED
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from plonky2_ecdsa_tpu_torch.prover.verifier import verify
from test_torch_bridge import from_reference_proof, to_reference_proof

# test_config with a 16-point final polynomial, so FRI folds several layers
_FRI = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
            final_poly_max_degree_bits=2)
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(**_FRI))
REF_FOLDING = RefConfig(range_lookup_limb_bits=3, fri=RefFri(**_FRI))


def _ref_data(ref_circuit, monkeypatch_env):
    monkeypatch_env.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    return ref_data_mod.build_circuit_data(ref_circuit)


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def demo(env):
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, batch=2)
    ref_c = ref_examples.small_demo_circuit().build()
    ref_data = _ref_data(ref_c, env)
    ref_W, ref_pis = ref_examples.small_demo_witness(ref_c, batch=2)
    return data, W, pis, ref_data, ref_prover.prove(ref_data, ref_W, ref_pis)


@pytest.fixture(scope="module")
def nonnative(env):
    c = nonnative_mul_chain_circuit(config=FOLDING).build()
    data = build_circuit_data(c, "cpu")
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    inputs = {"x": int_to_limbs(xs), "y": int_to_limbs(ys)}
    vals = c.value_table(inputs, 2)
    pis = c.public_input_values()
    W = c.generate_witness(inputs, 2)
    ref_c = ref_examples.nonnative_mul_chain_circuit(config=REF_FOLDING).build()
    ref_data = _ref_data(ref_c, env)
    ref_W = ref_c.generate_witness(inputs, 2)
    ref = ref_prover.prove(ref_data, ref_W, ref_c.public_input_values())
    return data, W, vals, pis, ref_data, ref


def test_demo_proof_equals_reference(demo):
    data, W, pis, ref_data, ref = demo
    got = prover.prove(data, W, pis)
    assert prover.first_difference(from_reference_proof(ref), got) is None
    assert verify(data, got)
    assert ref_verify(ref_data, to_reference_proof(got))


def test_nonnative_proof_equals_reference(nonnative):
    data, W, _vals, pis, ref_data, ref = nonnative
    assert len(ref.fri_proof.caps) == 4          # the folding layers are exercised
    got = prover.prove(data, W, pis)
    assert prover.first_difference(from_reference_proof(ref), got) is None
    assert verify(data, got)
    assert ref_verify(ref_data, to_reference_proof(got))


def test_run_vals_path_equals_witness_path(nonnative):
    data, _W, vals, pis, _ref_data, ref = nonnative
    got = prover.make_prover(data).run_vals(vals, pis)
    assert prover.first_difference(from_reference_proof(ref), got) is None


def _written(c, kind: str, role: str) -> int:
    """The first target a `kind` tape op writes as `role` that goes up (a
    wire cell's target, neither a derived limb nor a public input)."""
    up = np.setdiff1d(c.pos_tids, np.concatenate([c.derived_tids, c.pi_tids]))
    for op in c.tape:
        if op.rec is not None and op.rec[0] == kind and role in op.rec[1]:
            tids = c.read_map[np.ravel(np.asarray(op.rec[1][role], dtype=np.int64))]
            hit = tids[np.isin(tids, up)]
            if len(hit):
                return int(hit[0])
    raise AssertionError(f"no uploaded {kind}.{role} target")


@pytest.mark.parametrize("role,narrow", [("r", True), ("carry", False)])
def test_wide_value_goes_up_whole(nonnative, capfd, role, narrow):
    """Bit 40 set in lane 0 under a slot of mul_nn: its 29-bit product limb
    "r", which the reference sends in its u32 plane, or its 34-bit carry,
    which it sends as u64.  The one u64 table carries the value whole: no
    warning, no "wide" path, and the proof equals the reference's proof of
    the forged witness leaf for leaf.  The forged value is wrong for the
    circuit, so both verifiers reject that proof, which shows the 64-bit
    value went up and not a truncation; the honest table proves to the
    reference's proof afterwards.  Bit 40 lies above every range-lookup limb
    (at most 34 bits), so the limbs derived on the device are the honest
    ones."""
    data, W, vals, pis, ref_data, ref = nonnative
    c = data.circuit
    tid = _written(c, "mul_nn", role)
    assert vals[tid, 0] < 1 << 40
    ref_keep, ref_num_narrow = ref_prover._scatter_maps(ref_data)[3:5]
    assert (tid in ref_keep[:ref_num_narrow]) == narrow      # the reference's u32 plane
    bad = vals.copy()
    bad[tid, 0] |= np.uint64(1) << np.uint64(40)
    run = prover.make_prover(data)
    got = run.collect(run.dispatch_vals(bad, pis))
    assert capfd.readouterr().err == ""
    assert ("wide", 2) not in run.graph_stats and trace.batches()[-1].path == "vals"
    bad_W = c.witness_matrix(bad)                    # W, bit 40 on tid's cells in lane 0
    cells = c.pos_tids == tid
    flip = np.zeros_like(W)
    flip[c.pos_cols[cells], c.pos_rows[cells], 0] = np.uint64(1) << np.uint64(40)
    assert flip.any() and np.array_equal(bad_W ^ W, flip)
    want = ref_prover.prove(ref_data, bad_W, pis)
    assert prover.first_difference(from_reference_proof(want), got) is None
    assert not verify(data, got) and not ref_verify(ref_data, to_reference_proof(got))
    again = run.run_vals(vals, pis)
    assert capfd.readouterr().err == ""
    assert prover.first_difference(from_reference_proof(ref), again) is None


def test_exhausted_grind_is_rejected_at_collection(demo):
    ref = from_reference_proof(demo[4])
    poisoned = dataclasses.replace(ref, fri_proof=dataclasses.replace(
        ref.fri_proof, pow_witness=np.full_like(ref.fri_proof.pow_witness, GRIND_EXHAUSTED)))
    with pytest.raises(RuntimeError, match="exhausted"):
        prover.check_grind(poisoned)
    prover.check_grind(ref)


def test_first_difference_names_the_tampered_leaf(demo):
    data, _W, _pis, _ref_data, ref = demo
    ref = from_reference_proof(ref)
    bad = dataclasses.replace(ref, pis=ref.pis.copy())
    bad.pis[0, 0] ^= np.uint64(1)
    assert prover.first_difference(ref, bad) == "pis"
    assert not verify(data, bad)
