"""The port's exact single-lane verifier (Python integers) against the
reference's, on the CPU: both accept a lane, and a lane whose opening was
flipped fails the constraint identity while the other lane still passes."""

import copy

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover import verifier as ref_verifier
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

_FRI = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
            final_poly_max_degree_bits=2)
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(**_FRI))
REF_FOLDING = RefConfig(range_lookup_limb_bits=3, fri=RefFri(**_FRI))


@pytest.fixture(scope="module")
def case():
    """Demo circuit with folding FRI layers, B=2: the port's data and proof,
    and the reference's data and proof of the same witness."""
    c = small_demo_circuit(FOLDING).build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, batch=2)
    proof = prover.prove(data, W, pis)
    ref_c = ref_examples.small_demo_circuit(REF_FOLDING).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLONKY2_TPU_HOST_BUILD", "1")
        ref_data = ref_data_mod.build_circuit_data(ref_c)
    ref_W, ref_pis = ref_examples.small_demo_witness(ref_c, batch=2)
    return data, proof, ref_data, ref_prover.prove(ref_data, ref_W, ref_pis)


@pytest.mark.parametrize("lane", [0, 1])
def test_exact_verifier_agrees(case, lane):
    data, proof, ref_data, ref_proof = case
    assert verifier.verify_one_exact(data, proof, lane)
    if lane == 0:
        assert ref_verifier.verify_one_exact(ref_data, ref_proof, lane)
    bad = copy.deepcopy(proof)
    bad.openings0[0][lane, 3] ^= np.uint64(1)
    with pytest.raises(AssertionError, match="constraint identity"):
        verifier.verify_one_exact(data, bad, lane)
    assert verifier.verify_one_exact(data, bad, 1 - lane)     # lanes are independent


def _tamper(proof, what):
    bad = copy.deepcopy(proof)
    if what == "pow witness":
        bad.fri_proof.pow_witness[0] ^= np.uint64(1)
    elif what == "wires leaf":
        bad.initial_leaves["wires"][0, 2, 1] ^= np.uint64(1)
    elif what == "fri layer leaf":
        bad.fri_proof.layer_leaves[0][0, 4, 2] ^= np.uint64(1)
    elif what == "query index":
        bad.fri_proof.indices[0, 3] ^= 1
    return bad


@pytest.mark.parametrize("what,message", [
    ("pow witness", "PoW"), ("wires leaf", "initial merkle proof fails: wires"),
    ("fri layer leaf", "layer 0"), ("query index", "query indices mismatch")])
def test_exact_verifier_names_the_failing_check(case, what, message):
    data, proof, _ref_data, _ref_proof = case
    with pytest.raises(AssertionError, match=message):
        verifier.verify_one_exact(data, _tamper(proof, what), 0)
    assert not verifier.verify(data, _tamper(proof, what))
