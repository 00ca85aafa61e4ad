"""The work counts against hand counts at a tiny size, the frozen gate
counts against a recount, and the transcript count against the permutations
that the reference's verifier makes."""

import json
import os

from benchmark import work
from benchmark.ref import poseidon2, verifier
from benchmark.ref.circuit import Common
from benchmark.tools import count_gate_ops

TINY = {"n": 8,
        "config": {"num_wires": 4, "num_routed_wires": 4, "num_constant_cols": 2,
                   "num_challenges": 1, "permutation_chunk_size": 2, "rate_bits": 1,
                   "cap_height": 0, "num_query_rounds": 2, "proof_of_work_bits": 1,
                   "final_poly_max_degree_bits": 1},
        "gates": ["Arithmetic(20)", "Noop"], "pi": {"num_cols": 8, "count": 3, "rows": [5]},
        "k_coeffs": [1, 7, 49, 343], "lookup_gates": [], "lookup_mult_col": None,
        "fixed_cap": [["0", "0", "0", "0"]]}


def test_tree_permutations_by_hand():
    # 8 leaves of 12 elements: 2 absorptions each; 8 - 2 inner nodes below a cap of 2
    assert work._tree_permutations(8, 12, 1) == 8 * 2 + 6
    # 4 leaves of 4 under a cap as wide as the leaves: no inner node
    assert work._tree_permutations(4, 4, 4) == 4


def test_transcript_permutations_by_hand():
    # fixed cap 4 + pis 3 + wires cap 4 -> 1; beta, gamma -> 2; zs cap, alpha -> 3;
    # quotient cap, zeta -> 4; 34 opening words -> 5..8; FRI alpha -> 9; two layers'
    # caps and betas -> 10, 11; the final polynomial and the PoW response -> 12;
    # the witness and the response and the query indices -> 13
    assert work.transcript_permutations(Common(TINY)) == 13


def test_quotient_point_ops_by_hand():
    cm = Common(TINY)
    # Arithmetic(20): 60 mul, 40 add (frozen), + 20 filters, + 20 slot adds - 20 first terms
    gate_m, gate_a = 60 + 20, 40 + 20 - 20
    # 4 routed wires in 2 chunks of 2: 2 mul + 4 add a wire, per chunk 2 (chunk - 1) products
    # and 2 mul + 1 add for its step, L0 (Z - 1) 1 mul + 1 add
    perm_m, perm_a = 2 * 4 + 2 * (2 + 2) + 1, 4 * 4 + 2 + 1
    slots = 1 + 2 + 20
    m, a = work.quotient_point_ops(cm)
    assert (m, a) == (gate_m + perm_m + slots + 1, gate_a + perm_a + slots - 1)
    q = work.quotient_batch(cm, 2)
    assert q["instructions"] == 16 * 2 * (16 * m + 2 * a)
    # wires 4, zs 2, PI columns 8, quotient values 1 a lane; fixed 8 and three tables shared
    assert q["bytes"] == 8 * 16 * (2 * (4 + 2 + 8 + 1) + 8 + 3)


def test_frozen_gate_counts_match_a_recount():
    with open(count_gate_ops.OUT) as fh:
        table = json.load(fh)
    for gid, counts in table.items():
        assert count_gate_ops.count(gid) == counts, gid
    here = os.path.dirname(count_gate_ops.HERE)
    for name in ("secp256k1_ecdsa", "secp256k1_recursion"):
        with open(os.path.join(here, "benchmark", "configs", f"{name}.json")) as fh:
            assert set(json.load(fh)["circuit"]["gates"]) <= set(table)


def test_counting_algebra_counts_only_needed_work():
    alg = count_gate_ops.CountingAlgebra()
    v = count_gate_ops.VALUE
    alg.add(alg.zero(), v)
    alg.mul_const(v, 1)
    alg.mul(alg.zero(), v)
    assert (alg.muls, alg.adds) == (0, 0)
    alg.sub(v, v)
    alg.mul_const(v, 3)
    assert (alg.muls, alg.adds) == (1, 1)


def test_transcript_duplexes(monkeypatch):
    from benchmark import proofs
    from benchmark.selftest.test_bench_reference import entry_of
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
    c = small_demo_circuit().build()
    d = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, 2)
    common = Common(entry_of(c, d))
    proof = proofs.arrays(prover.prove(d, W, pis))
    count = {"n": 0}
    original = poseidon2.Challenger._duplex

    def counted(self):
        count["n"] += 1
        original(self)

    monkeypatch.setattr(poseidon2.Challenger, "_duplex", counted)
    assert verifier.accepted(verifier.verify(common, proof)).all()
    assert count["n"] == work.transcript_permutations(common)


def test_device_idle_share_by_hand():
    """Two traced batches of three graph launches each (one quotient chunk):
    from the first batch's first kernel (t=0) to the second's (t=10) the
    device ran [0, 5], [6, 8] and an upload [9, 10] outside any launch:
    busy 8 of 10."""
    from benchmark.run import HERE, Cell
    from benchmark.trace import Trace

    trace = Trace.__new__(Trace)
    trace.window = (-5, 30)
    trace.launches = [(t, cid) for t, cid in ((-1, 1), (1, 2), (3, 3), (8, 4), (9, 5), (10, 6))]
    trace.kernels = [("a", 0, 2, 11, 1), ("b", 2, 5, 12, 2), ("c", 6, 8, 13, 3),
                     ("upload", 9, 10, 14, 0),
                     ("a", 10, 12, 15, 4), ("b", 12, 20, 16, 5), ("c", 20, 24, 17, 6)]

    class Run:
        graph_stats = {"domain_chunks": 1}

    Run.trace = trace
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    reader = Cell(bench, bench["workloads"][0]["name"], 1).module("metrics", "device_idle_share")
    assert abs(reader.read(Run()) - 100 * (1 - 8 / 10)) < 1e-9
    assert reader.extra(Run()) == {"cycles": 1}
    Run.trace = None
    assert reader.read(Run()) is None