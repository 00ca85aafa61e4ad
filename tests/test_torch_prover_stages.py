"""Stage by stage: the port's prove_core (on its own circuit, witness and
fixed data) against the reference's numpy
prove_core at every stop_after knob (tolerance 0), and the domain-chunked
quotient and reduced polynomial against the unchunked reference."""

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import fri_cuda, prover
from plonky2_ecdsa_tpu_torch.prover.data import Backend, build_circuit_data

_FRI = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
            final_poly_max_degree_bits=2)
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(**_FRI))
REF_FOLDING = RefConfig(range_lookup_limb_bits=3, fri=RefFri(**_FRI))


@pytest.fixture(scope="module")
def case():
    c = small_demo_circuit(FOLDING).build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, batch=2)
    ref_c = ref_examples.small_demo_circuit(REF_FOLDING).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLONKY2_TPU_HOST_BUILD", "1")
        ref_data = ref_data_mod.build_circuit_data(ref_c)
    ref_W, ref_pis = ref_examples.small_demo_witness(ref_c, batch=2)
    ref_in = ref_prover.host_prep(ref_data, ref_W, ref_pis)
    return data, W, pis, ref_data, ref_in, ref_prover.Backend(ref_data, np), Backend(data)


def _run_both(case, stop_after):
    data, W, pis, ref_data, ref_in, ref_bk, bk = case
    want = ref_prover.prove_core(ref_data, ref_bk, *ref_in, np, stop_after=stop_after)
    got = prover.prove_core(data, bk, *prover._inputs_to_device(data, W, pis),
                            stop_after=stop_after)
    return got, want


def _assert_same(got, want):
    """Port tensors (int64 u64 patterns) vs reference (lo, hi) pairs, in any
    nesting of lists and tuples."""
    if isinstance(want, tuple) and len(want) == 2 and isinstance(want[0], np.ndarray):
        assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(*want))
    else:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)


@pytest.mark.parametrize("stop_after", ["commit", "challenges", "zs_vals", "zs",
                                        "quotient", "openings"])
def test_stage_matches_reference(case, stop_after):
    _assert_same(*_run_both(case, stop_after))


def test_fri_stage_matches_reference(case):
    got, want = _run_both(case, "fri_all")
    _assert_same(got.caps, want.caps)
    _assert_same(got.final_coeffs, want.final_coeffs)
    _assert_same(got.layer_leaves, want.layer_leaves)
    _assert_same(got.layer_paths, want.layer_paths)
    _assert_same(got.pow_witness, want.pow_witness)
    assert np.array_equal(got.indices.numpy(), want.indices.astype(np.int64))
    assert len(want.caps) == 1


def test_domain_chunked_passes_match_reference(case, monkeypatch):
    """The quotient and the FRI reduced polynomial evaluated in several
    domain chunks give the reference's (unchunked) commitments."""
    monkeypatch.setattr(prover, "DOMAIN_CHUNK", 8)      # N = 32: four chunks
    monkeypatch.setattr(fri_cuda, "PLAIN_CHUNK", 8)
    got, want = _run_both(case, "fri_all")
    _assert_same(got.caps, want.caps)
    _assert_same(got.final_coeffs, want.final_coeffs)
