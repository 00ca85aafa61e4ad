"""The P-256 proving path of the port against the reference, on the CPU,
tolerance 0 throughout (integers): the circuit build under p256_ecc_config
(64 constant columns, 31 range values a row, the 4-bit windowed
multiplication), the witness through both tapes, the static maps of the
compact upload, the device expand, the fixed commit and the wires commit
against the values frozen from the reference's numpy path, and (slow) a whole
proof under a reduced FRI config, leaf for leaf, through both verifiers."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu import api as ref_api
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.curve import native as ref_cn
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.prover.verifier import verify as ref_verify
from plonky2_ecdsa_tpu_torch import api
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import data as data_mod
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.verifier import verify, verify_one_exact
from test_torch_bridge import from_reference_proof, same_circuit, to_reference_proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
# Test processes run side by side: with a thread per core in each of them the
# full-width commits below spend minutes spinning on oversubscribed cores.
torch.set_num_threads(2)


def _tuples(stmts):
    return [(s.msg, s.r, s.s, s.pk.x, s.pk.y) for s in stmts]


@pytest.fixture(scope="module")
def anchors():
    with open(os.path.join(ROOT, "plonky2_ecdsa_tpu_torch", "vectors", "anchors.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def p256():
    return ref_api.EcdsaProverSystem(ref_cn.P256), api.EcdsaProverSystem(api.P256, device="cpu")


@pytest.fixture(scope="module")
def run(p256):
    """The production prover on the port's own fixed commit (plain kernels)."""
    return p256[1].prover


def test_p256_takes_its_own_config(p256):
    cfg = p256[1].circuit.config
    assert cfg == CircuitConfig.p256_ecc_config()
    assert (cfg.num_wires, cfg.num_routed_wires, cfg.num_constant_cols,
            cfg.range_lookup_vals) == (128, 80, 64, 31)
    assert api.EcdsaProverSystem.__init__.__defaults__[1] is None     # config=None


def test_unknown_curve_is_refused():
    other = dataclasses.replace(api.SECP256K1, name="other")
    with pytest.raises(ValueError, match="unsupported curve other"):
        api.EcdsaProverSystem(other, device="cpu")


def test_p256_random_statements_equal_reference():
    assert _tuples(api.random_statements(api.P256, 3, seed=SEED)) == \
        _tuples(ref_api.random_statements(ref_cn.P256, 3, seed=SEED))


def test_p256_circuit_build_equals_reference(p256):
    ref_sys, sys_ = p256
    assert same_circuit(ref_sys.circuit, sys_.circuit) == []
    assert sys_.n == ref_sys.n == 1 << 13
    assert sys_.num_rows == ref_sys.num_rows
    assert sys_.gate_counts() == ref_sys.gate_counts()
    lk = data_mod._lookup_info(sys_.circuit)
    assert np.array_equal(data_mod.fixed_values_of(sys_.circuit, lk)[:-1],
                          np.concatenate([ref_sys.circuit.constants, ref_sys.circuit.selectors,
                                          ref_sys.circuit.sigmas]))


def test_p256_widths(p256, run):
    """The widths that follow from 64 constant columns and 31 range values:
    LogUp helper columns, the zs commitment, the fixed commitment."""
    sys_ = p256[1]
    c, data = sys_.circuit, sys_.data
    lk = data.lookup
    terms = max(g.num_vals * g.terms_per_val for _gi, g in lk.gates)
    assert lk.num_batches == -(-terms // 3) and lk.cols_per_challenge == lk.num_batches + 2
    assert data.fixed_values.shape == (64 + len(c.gates) + 80 + 1, 1 << 13)
    assert lk.table_idx == data.fixed_values.shape[0] - 1
    assert data.fixed_lde.shape == (data.fixed_values.shape[0], 1 << 15)
    zs_width = 2 * (80 // 4) + 2 * lk.cols_per_challenge
    assert prover._z_columns(data) == [0, 20, 40 + lk.cols_per_challenge - 1, zs_width - 1]
    for _bits, V, nl, _lb in run._layout_meta:
        assert V == 31 and V + V * nl <= 128


@pytest.mark.parametrize("native", [True, False])
def test_p256_witness_equals_reference(p256, native):
    ref_sys, sys_ = p256
    inputs = sys_._inputs(api.random_statements(api.P256, 2, seed=SEED))
    vals = sys_.circuit.value_table(inputs, 2, native)
    assert sys_.circuit.last_tape_native is native
    assert np.array_equal(vals, ref_sys.circuit._run_tape(inputs, 2, native))
    assert np.array_equal(sys_.circuit.public_input_values(),
                          ref_sys.circuit.public_input_values())


def test_p256_value_table_and_witness_equal_reference(p256):
    ref_sys, sys_ = p256
    stmts = api.random_statements(api.P256, 2, seed=SEED)
    ref_stmts = ref_api.random_statements(ref_cn.P256, 2, seed=SEED)
    vals, pis = sys_.witness_vals(stmts)
    ref_vals, ref_pis = ref_sys.witness_vals(ref_stmts)
    assert np.array_equal(vals, ref_vals) and np.array_equal(pis, ref_pis)
    assert np.array_equal(pis[1], api.statement_pis(stmts[1]))
    assert api.limbs_to_int(pis[:, 18:27]) == [s.msg for s in stmts]
    W, _ = sys_.witness(stmts)
    ref_W, _ = ref_sys.witness(ref_stmts)
    assert np.array_equal(W, ref_W)


def test_p256_check_accepts_signatures_and_refuses_a_bad_one(p256):
    sys_ = p256[1]
    stmts = api.random_statements(api.P256, 2, seed=9)
    assert sys_.check(stmts)
    bad = dataclasses.replace(stmts[0], s=(stmts[0].s + 1) % api.P256.n)
    assert not sys_.check([stmts[1], bad])


def test_p256_upload_maps_equal_reference(p256):
    """_narrow_mask (with the windowed path's random_access bits) and every
    static gather map of the compact upload."""
    ref_sys, sys_ = p256
    assert any(op.rec and op.rec[0] == "random_access" for op in sys_.circuit.tape)
    assert np.array_equal(prover._narrow_mask(sys_.circuit),
                          ref_prover._narrow_mask(ref_sys.circuit))
    got = prover._scatter_maps(types.SimpleNamespace(circuit=sys_.circuit, n=sys_.n))
    want = ref_prover._scatter_maps(types.SimpleNamespace(circuit=ref_sys.circuit, n=ref_sys.n))
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g, w)
    assert got[4] == want[4] and got[6] == want[6]
    assert all(np.array_equal(g, w) for g, w in zip(got[5], want[5]))


def test_p256_device_expand_and_host_expand_equal_the_witness(p256, run):
    """The compact table gathered on the device (range limbs re-derived at
    V = 31) and the fallback's host expansion both give the witness matrix."""
    sys_ = p256[1]
    stmts = api.random_statements(api.P256, 2, seed=SEED)
    vals, pis = sys_.witness_vals(stmts)
    W = sys_.circuit.generate_witness(sys_._inputs(stmts), 2)
    vn, vw = run._vals_split(vals)
    wires, pi, pis_dev = run._expand(torch.from_numpy(vn.view(np.int32)), gl.from_u64(vw, "cpu"))
    want_wires, want_pi = prover.host_prep(sys_.data, W, pis)
    assert np.array_equal(gl.to_u64(wires), want_wires)
    assert np.array_equal(gl.to_u64(pi), want_pi)
    assert np.array_equal(gl.to_u64(pis_dev), pis)
    assert np.array_equal(run._expand_host(vals), W)


def test_p256_fixed_commit_meets_the_anchor(p256, anchors):
    data = p256[1].data
    assert anchors["p256_n"] == data.n == 1 << 13
    assert [f"{int(v):016x}" for v in gl.to_u64(data.fixed_tree.cap).ravel()] == \
        anchors["p256_fixed_cap"]


def test_p256_wires_commit_meets_the_anchor(p256, run, anchors):
    """stop_after="commit" of the production path at B=1: lane 0's wires cap
    equals the reference's numpy commitment."""
    sys_ = p256[1]
    vals, _pis = sys_.witness_vals(api.random_statements(api.P256, 1, seed=anchors["seed"]))
    vn, vw = run._vals_split(vals)
    cap = prover.prove_core(sys_.data, run.backend,
                            *run._expand(torch.from_numpy(vn.view(np.int32)),
                                         gl.from_u64(vw, "cpu")), stop_after="commit")
    assert [f"{int(v):016x}" for v in gl.to_u64(cap)[0].ravel()] == \
        anchors["p256_lane0_wires_cap"]


@pytest.mark.slow
def test_p256_whole_proof_equals_reference(monkeypatch):
    """One P-256 signature under a reduced FRI config (6 queries, no PoW):
    the port's run_vals proof equals the reference's numpy proof leaf for
    leaf; both verifiers accept it and reject it with a public input flipped."""
    monkeypatch.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    fri = dict(rate_bits=2, cap_height=1, num_query_rounds=6, proof_of_work_bits=0)
    ref_sys = ref_api.EcdsaProverSystem(
        ref_cn.P256, config=RefConfig(num_constant_cols=64, range_lookup_vals=31,
                                      fri=RefFri(**fri)))
    sys_ = api.EcdsaProverSystem(
        api.P256, config=CircuitConfig(num_constant_cols=64, range_lookup_vals=31,
                                       fri=FriConfig(**fri)), device="cpu")
    stmts = api.random_statements(api.P256, 1, seed=17)
    ref_W, ref_pis = ref_sys.witness(ref_api.random_statements(ref_cn.P256, 1, seed=17))
    want = ref_prover.prove(ref_sys.data, ref_W, ref_pis)
    got = sys_.prove(stmts)
    assert prover.first_difference(from_reference_proof(want), got) is None
    assert verify(sys_.data, got) and verify_one_exact(sys_.data, got, 0)
    assert sys_.verify_statement(got, 0, stmts[0])
    assert ref_verify(ref_sys.data, to_reference_proof(got))
    bad = dataclasses.replace(got, pis=got.pis.copy())
    bad.pis[0, 0] ^= np.uint64(1)
    assert not verify(sys_.data, bad)
    assert not ref_verify(ref_sys.data, to_reference_proof(bad))
