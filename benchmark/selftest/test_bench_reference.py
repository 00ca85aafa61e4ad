"""The plain reference against the program on the CPU: its field and
Poseidon2 against Python integers and the program's plain permutation, each
gate's constraints against the program's gates, and the verifier on a tiny
circuit's proof, accepted as proved and rejected once altered."""

import numpy as np
import pytest
import torch

from benchmark import ecdsa, proofs, traffic
from benchmark.ref import field as f
from benchmark.ref import gates as rg
from benchmark.ref import poseidon2 as ps
from benchmark.ref import verifier
from benchmark.ref.circuit import Common

torch.set_num_threads(2)
P = f.P


def test_field_against_python_integers():
    g = np.random.default_rng(3)
    a = np.concatenate([g.integers(0, 2**63, 500, dtype=np.uint64) * np.uint64(2) % np.uint64(P),
                        np.array([0, 1, P - 1, P - 2, 2**32, 2**63], np.uint64)])
    b = a[::-1].copy()
    for fn, ref in ((f.mul, lambda x, y: x * y % P), (f.add, lambda x, y: (x + y) % P),
                    (f.sub, lambda x, y: (x - y) % P)):
        assert [int(v) for v in fn(a, b)] == [ref(int(x), int(y)) for x, y in zip(a, b)]
    assert [int(v) for v in f.inverse(a[a != 0][:20])] == [pow(int(x), -1, P) for x in a[a != 0][:20]]


def test_poseidon2_against_the_programs_plain_permutation():
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    from plonky2_ecdsa_tpu_torch.hash import poseidon
    g = np.random.default_rng(4)
    state = g.integers(0, 2**63, (12, 17), dtype=np.uint64) * np.uint64(2) % np.uint64(P)
    mine = ps.permute(state)
    theirs = gl.to_u64(poseidon.permute_plain(gl.from_u64(state, "cpu")))
    assert (mine == np.asarray(theirs, np.uint64)).all()


@pytest.fixture(scope="module")
def flat_circuit():
    from plonky2_ecdsa_tpu_torch import api
    return api.EcdsaProverSystem(device="cpu").circuit


def test_every_gate_against_the_programs_gates(flat_circuit):
    from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchExtAlgebra
    from plonky2_ecdsa_tpu_torch.circuit.poseidon_gate import PoseidonGate
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    g = np.random.default_rng(5)
    L = 3

    def rand(k):
        return [tuple(g.integers(0, 2**63, L, dtype=np.uint64) for _ in range(2)) for _ in range(k)]

    def up(e):
        return (gl.from_u64(e[0], "cpu"), gl.from_u64(e[1], "cpu"))

    for gate in list(flat_circuit.gates) + [PoseidonGate()]:
        w, c, pv = rand(max(gate.num_wires, 1)), rand(32), rand(8)
        theirs = gate.eval(TorchExtAlgebra((L,), "cpu"), [up(x) for x in w], [up(x) for x in c],
                           {"pi_vals": [up(x) for x in pv]})
        mine = rg.parse(gate.gate_id()).eval(f.ExtAlgebra((L,)), w, c, {"pi_vals": pv})
        assert len(mine) == len(theirs) == gate.num_constraints
        for x, y in zip(mine, theirs):
            assert (x[0] == gl.to_u64(y[0])).all() and (x[1] == gl.to_u64(y[1])).all(), gate.gate_id()


def entry_of(circuit, data) -> dict:
    """A circuit entry as the configurations freeze it, of the program's
    build of a test circuit."""
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    cfg, lk = circuit.config, data.lookup
    return {"n": circuit.n,
            "config": {"num_wires": cfg.num_wires, "num_routed_wires": cfg.num_routed_wires,
                       "num_constant_cols": cfg.num_constant_cols,
                       "num_challenges": cfg.num_challenges,
                       "permutation_chunk_size": cfg.permutation_chunk_size,
                       "rate_bits": cfg.fri.rate_bits, "cap_height": cfg.fri.cap_height,
                       "num_query_rounds": cfg.fri.num_query_rounds,
                       "proof_of_work_bits": cfg.fri.proof_of_work_bits,
                       "final_poly_max_degree_bits": cfg.fri.final_poly_max_degree_bits},
            "gates": [gt.gate_id() for gt in circuit.gates],
            "pi": {"num_cols": circuit.pi.num_cols, "count": circuit.pi.count,
                   "rows": [int(r) for r in circuit.pi.rows]},
            "k_coeffs": [int(k) for k in circuit.k_coeffs],
            "lookup_gates": [gi for gi, _g in lk.gates] if lk else [],
            "lookup_mult_col": lk.mult_col if lk else None,
            "fixed_cap": [[f"{int(v):016x}" for v in row] for row in gl.to_u64(data.fixed_tree.cap)]}


@pytest.fixture(scope="module")
def demo():
    """The program's tiny demo circuit (n = 2^6, lookups on) and a proof of
    two lanes."""
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
    c = small_demo_circuit().build()
    d = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, 2)
    return Common(entry_of(c, d)), proofs.arrays(prover.prove(d, W, pis))


def test_reference_accepts_the_programs_proof(demo):
    common, proof = demo
    assert common.lookup is not None
    assert verifier.accepted(verifier.verify(common, proof)).all()


@pytest.mark.parametrize("alter", ["pis", "opening", "quotient_leaf", "fri_final", "pow", "cap"])
def test_reference_rejects_an_altered_lane(demo, alter):
    common, proof = demo
    p = proofs.lanes([(proof, [0, 1])])                 # a copy
    if alter == "pis":
        p["pis"][1, 0] ^= np.uint64(1)
    elif alter == "opening":
        p["openings0"][0][1, common.offsets[1] + 3] ^= np.uint64(1)
    elif alter == "quotient_leaf":
        p["initial_leaves"]["quot"][1, 0, 0] ^= np.uint64(1)
    elif alter == "fri_final":
        p["final_coeffs"][1][1, 0] ^= np.uint64(1)
    elif alter == "pow":
        p["pow_witness"][1] ^= np.uint64(1)
    else:
        p["zs_cap"][1, 0, 0] ^= np.uint64(1)
    assert verifier.accepted(verifier.verify(common, p)).tolist() == [True, False]


def test_the_frozen_flat_circuit_is_the_programs_build():
    """The configuration's circuit entry equals what the program builds and
    commits today, and its verifying key is the one the reference package
    froze into anchors.json."""
    import json
    import os

    from benchmark.tools import freeze_circuit
    with open(os.path.join(freeze_circuit.CONFIGS, "secp256k1_ecdsa.json")) as fh:
        spec = json.load(fh)
    assert freeze_circuit.entry(spec) == spec["circuit"]


def test_statements_and_their_public_inputs():
    pool = traffic.statement_pool("secp256k1", {"batch": 3, "pool_batches": 2, "in_flight": 1},
                                  2**31 + 5)
    again = traffic.statement_pool("secp256k1", {"batch": 3, "pool_batches": 2, "in_flight": 1},
                                   2**31 + 5)
    assert pool == again and len(pool) == 2 and len(pool[0]) == 3
    c = ecdsa.CURVES["secp256k1"]
    assert all(ecdsa.verify(c, st) for b in pool for st in b)
    st = pool[0][0]
    assert not ecdsa.verify(c, ecdsa.Statement(st.msg ^ 1, st.r, st.s, st.pk))
    from plonky2_ecdsa_tpu_torch import api
    theirs = api.statement_pis(api.EcdsaStatement(msg=st.msg, r=st.r, s=st.s,
                                                  pk=api.cn.Point(api.SECP256K1, *st.pk)))
    assert [int(v) for v in theirs] == ecdsa.public_inputs(st)
