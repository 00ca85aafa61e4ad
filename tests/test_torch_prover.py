"""Whole proofs: the port's prover against the reference's numpy prove,
leaf for leaf (tolerance 0), on the demo and nonnative-mul circuits; the
production run_vals path against the full-witness path; and the loud
failures (narrow-plane violation, exhausted grind, tampered proof)."""

import dataclasses

import numpy as np
import pytest

from plonky2_ecdsa_tpu.api import int_to_limbs
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu.circuit.examples import (nonnative_mul_chain_circuit,
                                                small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu.curve import native as cn
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover.challenger import GRIND_EXHAUSTED
from plonky2_ecdsa_tpu.prover.verifier import verify
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

# test_config with a 16-point final polynomial, so FRI folds several layers
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(
    rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
    final_poly_max_degree_bits=2))


@pytest.fixture(scope="module")
def demo():
    c = small_demo_circuit().build()
    data = build_circuit_data(c)
    W, pis = small_demo_witness(c, batch=2)
    return data, W, pis, ref_prover.prove(data, W, pis)


@pytest.fixture(scope="module")
def nonnative():
    c = nonnative_mul_chain_circuit(config=FOLDING).build()
    data = build_circuit_data(c)
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    inputs = {"x": int_to_limbs(xs), "y": int_to_limbs(ys)}
    vals = c._run_tape(inputs, 2, None)
    pis = c.public_input_values()
    W = c.generate_witness(inputs, 2)
    return data, W, vals, pis, ref_prover.prove(data, W, pis)


def test_demo_proof_equals_reference(demo):
    data, W, pis, ref = demo
    got = prover.prove(data, W, pis)
    assert prover.first_difference(ref, got) is None
    assert verify(data, got)


def test_nonnative_proof_equals_reference(nonnative):
    data, W, _vals, pis, ref = nonnative
    assert len(ref.fri_proof.caps) == 4          # the folding layers are exercised
    got = prover.prove(data, W, pis)
    assert prover.first_difference(ref, got) is None
    assert verify(data, got)


def test_run_vals_path_equals_witness_path(nonnative):
    data, _W, vals, pis, ref = nonnative
    got = prover.make_prover(data, "cpu").run_vals(vals, pis)
    assert prover.first_difference(ref, got) is None


def test_narrow_plane_violation_raises(nonnative):
    data, _W, vals, pis, _ref = nonnative
    c = data.circuit
    mask = ref_prover._narrow_mask(c)
    mask[c.derived_tids] = False
    bad = vals.copy()
    bad[int(np.nonzero(mask)[0][0]), 0] |= np.uint64(1) << np.uint64(40)
    with pytest.raises(prover.NarrowMisclassification):
        prover.make_prover(data, "cpu").dispatch_vals(bad, pis)


def test_exhausted_grind_is_rejected_at_collection(demo):
    ref = demo[3]
    lo, hi = ref.fri_proof.pow_witness
    poisoned = dataclasses.replace(ref, fri_proof=dataclasses.replace(
        ref.fri_proof, pow_witness=(np.full_like(lo, GRIND_EXHAUSTED), hi)))
    with pytest.raises(RuntimeError, match="exhausted"):
        prover.check_grind(poisoned)
    prover.check_grind(ref)


def test_first_difference_names_the_tampered_leaf(demo):
    data, _W, _pis, ref = demo
    bad = dataclasses.replace(ref, pis=ref.pis.copy())
    bad.pis[0, 0] ^= np.uint64(1)
    assert prover.first_difference(ref, bad) == "pis"
    assert not verify(data, bad)
