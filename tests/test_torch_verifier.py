"""The port's verifier (torch, on an explicit device) against the
reference's numpy verifier, on the CPU: both accept the port's proofs and the
reference's, and both reject every tampered proof tried.  Tolerance 0: a
verdict is a verdict."""

import copy

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover import verifier as ref_verifier
from plonky2_ecdsa_tpu_torch.circuit.algebra import BaseAlgebra, TorchAlgebra, TorchExtAlgebra
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import merkle
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.challenger import GRIND_EXHAUSTED, Challenger
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from test_torch_bridge import from_reference_proof, to_reference_proof

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


def _flip(arr, index):
    arr[index] ^= np.uint64(1)


def _poison_grind(p):
    p.fri_proof.pow_witness[1] = np.uint64(GRIND_EXHAUSTED)


TAMPERS = {
    "pis bit": lambda p: _flip(p.pis, (0, 0)),
    "openings0 word": lambda p: _flip(p.openings0[0], (1, 3)),
    "openings0 c1 word": lambda p: _flip(p.openings0[1], (0, p.layout.total - 1)),
    "openings1 word": lambda p: _flip(p.openings1[0], (0, 0)),
    "GRIND_EXHAUSTED witness": _poison_grind,
    "wires cap": lambda p: _flip(p.wires_cap, (0, 0, 0)),
    "zs cap": lambda p: _flip(p.zs_cap, (1, 1, 2)),
    "quotient cap": lambda p: _flip(p.quotient_cap, (0, 1, 3)),
    "wires leaf": lambda p: _flip(p.initial_leaves["wires"], (0, 2, 1)),
    "fixed path": lambda p: _flip(p.initial_paths["fixed"], (1, 0, 0, 0)),
    "fri layer cap": lambda p: _flip(p.fri_proof.caps[0], (0, 0, 0)),
    "fri layer leaf": lambda p: _flip(p.fri_proof.layer_leaves[0], (1, 4, 2)),
    "fri layer path": lambda p: _flip(p.fri_proof.layer_paths[0], (0, 5, 0, 1)),
    "final coefficient": lambda p: _flip(p.fri_proof.final_coeffs[1], (1, 2)),
    "query index": lambda p: _flip(p.fri_proof.indices.view(np.uint64), (0, 3)),
}


def test_both_verifiers_accept_both_proofs(case):
    data, proof, ref_data, ref_proof = case
    assert prover.first_difference(from_reference_proof(ref_proof), proof) is None
    assert verifier.verify_strict(data, proof)
    assert verifier.verify(data, from_reference_proof(ref_proof))
    assert ref_verifier.verify(ref_data, to_reference_proof(proof))
    assert ref_verifier.verify(ref_data, ref_proof)


@pytest.mark.parametrize("what", sorted(TAMPERS))
def test_both_verifiers_reject_tampered_proof(case, what):
    data, proof, ref_data, _ref_proof = case
    bad = copy.deepcopy(proof)
    TAMPERS[what](bad)
    assert prover.first_difference(proof, bad) is not None
    assert not verifier.verify(data, bad)
    assert not ref_verifier.verify(ref_data, to_reference_proof(bad))


def test_strict_verifier_names_the_failing_check_and_lane(case):
    data, proof, _ref_data, _ref_proof = case
    bad = copy.deepcopy(proof)
    TAMPERS["openings0 word"](bad)
    with pytest.raises(verifier.VerifyError, match="lane 1"):
        verifier.verify_strict(data, bad)
    bad = copy.deepcopy(proof)
    _poison_grind(bad)
    with pytest.raises(verifier.VerifyError, match="PoW"):
        verifier.verify_strict(data, bad)


def test_malformed_proof_is_rejected_not_raised(case):
    data, proof, _ref_data, _ref_proof = case
    bad = copy.deepcopy(proof)
    bad.initial_leaves.pop("zs")
    assert not verifier.verify(data, bad)
    bad = copy.deepcopy(proof)
    bad.fri_proof.pow_witness = None
    assert not verifier.verify(data, bad)
    bad = copy.deepcopy(proof)
    bad.openings0 = (bad.openings0[0][:, :-1], bad.openings0[1][:, :-1])
    assert not verifier.verify(data, bad)


def test_replay_gives_the_provers_challenges(case):
    data, proof, ref_data, ref_proof = case
    got = verifier.replay_challenges_to_zeta(data, verifier._to_device(proof, "cpu"))
    want = ref_verifier.replay_challenges_to_zeta(ref_data, ref_proof)
    for g, w in zip(got[1:5], want[1:5]):          # betas, gammas, lk_alphas, alphas
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.array_equal(gl.to_u64(a), ref_verifier._u64(b))
    for i in range(2):
        assert np.array_equal(gl.to_u64(got[5][i]), ref_verifier._u64(want[5][i]))
    assert got[6] == want[6]


def test_merkle_path_check_batched_and_shared_cap():
    rng = np.random.default_rng(4)
    leaves = gl.from_u64(rng.integers(0, gl.P, (3, 16, 5), dtype=np.uint64))
    tree = merkle.build_merkle_tree(leaves, 1)
    idx = gl.from_u64(rng.integers(0, 16, (3, 6), dtype=np.uint64))
    opened = leaves[np.arange(3)[:, None], idx]
    paths = tree.open(idx)
    assert bool(verifier.verify_merkle_paths(opened, idx, paths, tree.cap).all())
    wrong = verifier.verify_merkle_paths(opened, idx ^ 1, paths, tree.cap)
    assert not bool(wrong.any())
    one = merkle.build_merkle_tree(leaves[0], 2)           # unbatched tree, shared cap
    assert one.cap.shape == (4, 4)
    ok = verifier.verify_merkle_paths(leaves[0][idx[0]], idx[0], one.open(idx[:1])[0], one.cap)
    assert bool(ok.all())


def test_check_pow_is_the_verifiers_side_of_grind():
    rng = np.random.default_rng(6)
    seed = gl.from_u64(rng.integers(0, gl.P, (3, 5), dtype=np.uint64))
    a, b = Challenger((3,)), Challenger((3,))
    a.observe_array(seed)
    b.observe_array(seed)
    w = a.grind(6)
    assert bool(b.check_pow(w, 6).all())
    assert np.array_equal(gl.to_u64(a.get_challenge()), gl.to_u64(b.get_challenge()))
    c = Challenger((3,))
    c.observe_array(seed)
    assert not bool(c.check_pow(w + 1, 20).all())


def test_algebras_agree_on_a_gate(case):
    """One gate's constraints under the three algebras: host numpy, tensors,
    and the extension algebra on base-field inputs (c1 stays 0)."""
    data = case[0]
    c = data.circuit
    rng = np.random.default_rng(8)
    for gate in c.gates:
        if gate.num_constraints == 0 or gate.gate_id().startswith("PublicInput"):
            continue
        w = rng.integers(0, gl.P, (gate.num_wires, 4), dtype=np.uint64)
        k = rng.integers(0, gl.P, (c.config.num_constant_cols, 4), dtype=np.uint64)
        host = gate.eval(BaseAlgebra(), list(w), list(k), {})
        tw, tk = [gl.from_u64(r) for r in w], [gl.from_u64(r) for r in k]
        base = gate.eval(TorchAlgebra((4,), "cpu"), tw, tk, {})
        zero = gl.const(0, (4,))
        ext = gate.eval(TorchExtAlgebra((4,), "cpu"), [(t, zero) for t in tw],
                        [(t, zero) for t in tk], {})
        assert len(host) == len(base) == len(ext) == gate.num_constraints
        for h, t, e in zip(host, base, ext):
            want = np.broadcast_to(h, (4,))
            assert np.array_equal(gl.to_u64(t.expand(4)), want), gate.gate_id()
            assert np.array_equal(gl.to_u64(e[0].expand(4)), want), gate.gate_id()
            assert not gl.to_u64(e[1]).any()
