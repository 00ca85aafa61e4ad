"""Whole proofs: the port's own circuit, witness, fixed data and prover
against the reference's numpy prove, leaf for leaf (tolerance 0), on the demo
and nonnative-mul circuits; the production run_vals path against the
full-witness path; the loud wide-path fallback on a narrow-plane violation;
and the loud failures (exhausted grind, tampered proof)."""

import dataclasses

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover.verifier import verify as ref_verify
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


def _forged(data, vals):
    """The value table with bit 40 set under the first narrow-classified slot
    that is uploaded, and that slot."""
    c = data.circuit
    mask = prover._narrow_mask(c)
    mask[c.derived_tids] = False                     # derived targets are not uploaded
    tid = int(np.nonzero(mask)[0][0])
    bad = vals.copy()
    bad[tid, 0] |= np.uint64(1) << np.uint64(40)
    return bad, tid


def test_narrow_plane_violation_raises(nonnative):
    """NarrowMisclassification stays the internal signal: the split of the
    table raises it; dispatch_vals catches it (next test)."""
    data, _W, vals, _pis, _ref_data, _ref = nonnative
    bad, tid = _forged(data, vals)
    with pytest.raises(prover.NarrowMisclassification, match=rf"\[{tid}\]"):
        prover.make_prover(data)._vals_split(bad)


def test_narrow_plane_violation_falls_back_to_wide_path(nonnative, capfd):
    """Counterpart of the reference's test_misclassified_wide_value_falls_
    back_to_wide_path: a value >= 2^32 under a narrow-classified slot is not
    truncated and the batch is not lost.  dispatch_vals warns on stderr and
    proves the host-expanded witness through the full-witness path: the proof
    equals the reference's wide-path proof of the same forged table leaf for
    leaf.  The forged value is wrong for the circuit, so (as in the reference)
    both verifiers reject that proof, which shows the real 64-bit value went
    up and not a truncation; an honest table proves through the narrow path
    afterwards."""
    data, W, vals, pis, ref_data, ref = nonnative
    bad, tid = _forged(data, vals)
    run = prover.make_prover(data)
    got = run.collect(run.dispatch_vals(bad, pis))
    err = capfd.readouterr().err
    assert "falling back to the wide witness path" in err and f"[{tid}]" in err
    bad_W = run._expand_host(bad)
    assert int((bad_W != W).sum()) >= 1 and np.array_equal(bad_W >> np.uint64(40) << np.uint64(40),
                                                           bad_W ^ W)
    want = ref_prover.prove(ref_data, bad_W, pis)
    assert prover.first_difference(from_reference_proof(want), got) is None
    assert not verify(data, got) and not ref_verify(ref_data, to_reference_proof(got))
    again = run.run_vals(vals, pis)
    assert capfd.readouterr().err == ""
    assert prover.first_difference(from_reference_proof(ref), again) is None


def test_misclassified_role_falls_back_and_still_proves(nonnative, capfd, monkeypatch):
    """The fault the fallback exists for: a tape role classified narrow whose
    honest values are wider (here the 34-bit carries of mul_nn declared
    narrow).  The honest table then takes the wide path, with the warning,
    and gives the very proof of the narrow path, which both verifiers accept."""
    data, _W, vals, pis, ref_data, ref = nonnative
    monkeypatch.setitem(prover._NARROW_ROLES, "mul_nn", ("q", "r", "carry"))
    run = prover.make_prover(data)
    got = run.run_vals(vals, pis)
    assert "falling back to the wide witness path" in capfd.readouterr().err
    assert prover.first_difference(from_reference_proof(ref), got) is None
    assert verify(data, got) and ref_verify(ref_data, to_reference_proof(got))


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
