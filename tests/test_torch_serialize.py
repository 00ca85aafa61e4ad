"""Persistence round trips of the port (prover/serialize.py), on the CPU,
tolerance 0: loaded circuit data has the same fixed cap and proves to the
same digest; a loaded proof equals the saved one leaf for leaf and passes the
reference's verifier through the bridge; a rebuilt template reattaches."""

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover.verifier import verify as ref_verify
from plonky2_ecdsa_tpu_torch.api import int_to_limbs
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import (nonnative_mul_chain_circuit,
                                                      small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from plonky2_ecdsa_tpu_torch.prover.serialize import (attach_template, load_circuit_data,
                                                      load_proof, save_circuit_data, save_proof)
from plonky2_ecdsa_tpu_torch.prover.verifier import verify
from test_torch_bridge import to_reference_proof

_FRI = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
            final_poly_max_degree_bits=2)
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(**_FRI))
REF_FOLDING = RefConfig(range_lookup_limb_bits=3, fri=RefFri(**_FRI))


@pytest.fixture(scope="module")
def chain():
    """The nonnative-mul circuit (lookups, several FRI layers): data, value
    table, PIs and the proof of the production path."""
    c = nonnative_mul_chain_circuit(config=FOLDING).build()
    data = build_circuit_data(c, "cpu")
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    inputs = {"x": int_to_limbs(xs), "y": int_to_limbs(ys)}
    vals = c.value_table(inputs, 2)
    pis = c.public_input_values()
    return data, inputs, vals, pis, prover.Prover(data).run_vals(vals, pis)


def test_circuit_data_round_trip_keeps_every_field(chain, tmp_path):
    data = chain[0]
    path = str(tmp_path / "chain.npz")
    save_circuit_data(data, path)
    loaded = load_circuit_data(path, "cpu")
    for name in ("n", "N", "g", "num_constraint_slots", "perm_slots", "device"):
        assert getattr(loaded, name) == getattr(data, name), name
    for name in ("fixed_values", "id_encodings", "x_lde", "zh_inv", "l0_lde"):
        got = getattr(loaded, name)
        assert got.dtype == np.uint64 and np.array_equal(got, getattr(data, name)), name
    assert loaded.fixed_coeffs.equal(data.fixed_coeffs) and loaded.fixed_lde.equal(data.fixed_lde)
    assert loaded.fixed_tree.cap_height == data.fixed_tree.cap_height
    assert len(loaded.fixed_tree.levels) == len(data.fixed_tree.levels)
    assert all(a.equal(b) for a, b in zip(loaded.fixed_tree.levels, data.fixed_tree.levels))
    assert np.array_equal(gl.to_u64(loaded.fixed_tree.cap), gl.to_u64(data.fixed_tree.cap))
    assert loaded.circuit.config == data.circuit.config
    assert [g.gate_id() for g in loaded.circuit.gates] == [g.gate_id() for g in data.circuit.gates]
    assert dataclass_fields(loaded.lookup) == dataclass_fields(data.lookup)
    assert loaded.circuit.tape == [] and loaded.circuit.lookup_mult_col == data.circuit.lookup_mult_col


def dataclass_fields(lk):
    return (lk.mult_col, lk.table_idx, lk.num_batches, lk.cols_per_challenge, lk.slots,
            [gi for gi, _g in lk.gates])


def test_loaded_data_proves_to_the_same_digest(chain, tmp_path):
    data, _inputs, vals, pis, proof = chain
    path = str(tmp_path / "chain.npz")
    save_circuit_data(data, path)
    loaded = load_circuit_data(path, "cpu")
    got = prover.Prover(loaded).run_vals(vals, pis)
    assert prover.first_difference(proof, got) is None
    assert prover.proof_digest(got) == prover.proof_digest(proof)
    assert verify(loaded, got) and verify(data, got)


def test_attach_template_enables_witness_generation(chain, tmp_path):
    data, inputs, _vals, _pis, proof = chain
    path = str(tmp_path / "chain.npz")
    save_circuit_data(data, path)
    loaded = load_circuit_data(path, "cpu")
    attach_template(loaded, nonnative_mul_chain_circuit(config=FOLDING).build())
    vals = loaded.circuit.value_table(inputs, 2)
    got = prover.Prover(loaded).run_vals(vals, loaded.circuit.public_input_values())
    assert prover.first_difference(proof, got) is None
    with pytest.raises(ValueError, match="template mismatch"):
        attach_template(loaded, small_demo_circuit().build())


def test_proof_round_trip_is_leaf_for_leaf(chain, tmp_path):
    data, _inputs, _vals, _pis, proof = chain
    path = str(tmp_path / "proof.npz")
    save_proof(proof, path)
    loaded = load_proof(path)
    assert prover.first_difference(proof, loaded) is None
    assert loaded.layout == proof.layout
    assert isinstance(loaded.openings0, tuple) and isinstance(loaded.fri_proof.caps, list)
    assert len(loaded.fri_proof.caps) == 4 and loaded.fri_proof.indices.dtype == np.int64
    assert sorted(loaded.initial_leaves) == ["fixed", "quot", "wires", "zs"]
    assert verify(data, loaded)
    with np.load(path, allow_pickle=False) as z:       # no member is a pickled object
        assert all(z[k].dtype in (np.uint64, np.int64) for k in z.files)


def test_loaded_proof_passes_the_reference_verifier(chain, tmp_path, monkeypatch):
    _data, _inputs, _vals, _pis, proof = chain
    path = str(tmp_path / "proof.npz")
    save_proof(proof, path)
    monkeypatch.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    ref_data = ref_data_mod.build_circuit_data(
        ref_examples.nonnative_mul_chain_circuit(config=REF_FOLDING).build())
    assert ref_verify(ref_data, to_reference_proof(load_proof(path)))


def test_proof_without_pow_witness_round_trips(tmp_path):
    """proof_of_work_bits = 0 leaves pow_witness None: no such leaf is
    written and None comes back."""
    cfg = CircuitConfig(range_lookup_limb_bits=3,
                        fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                                      proof_of_work_bits=0))
    c = small_demo_circuit(cfg).build()
    data = build_circuit_data(c, "cpu")
    proof = prover.prove(data, *small_demo_witness(c, 2))
    assert proof.fri_proof.pow_witness is None
    path = str(tmp_path / "proof.npz")
    save_proof(proof, path)
    loaded = load_proof(path)
    assert loaded.fri_proof.pow_witness is None
    assert prover.first_difference(proof, loaded) is None and verify(data, loaded)
