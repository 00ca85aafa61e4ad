"""Frozen values taken from the reference package, against which the port is
held where the reference cannot run (the GPU smoke run imports the port
alone): ``plonky2_ecdsa_tpu_torch/vectors/anchors.json``.

    JAX_PLATFORMS=cpu python tests/test_torch_anchors.py --write

recomputes the file with the reference's numpy path: for secp256k1 and for
P-256, the fixed commit, the wires commit and one whole B=1 proof; the demo
recursion (the demo inner proof at B=2, its verifier circuit's value table,
fixed cap and outer proof); and the verifier circuit of the secp256k1 circuit
under recursion_ecc_config (its structure and its fixed cap).  No witness or
proof of that production verifier circuit is frozen: the reference's numpy
tape alone would take about 15 minutes of the run.  The tests here check
that the file holds what the reference gives where that is quick (the demo
proof), and that the port on the CPU meets the same values (the production
verifier circuit's fixed cap only in the slow set: its commit at 2^17 takes
minutes on the CPU)."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from plonky2_ecdsa_tpu import api as ref_api  # noqa: E402
from plonky2_ecdsa_tpu.circuit import examples as ref_examples  # noqa: E402
from plonky2_ecdsa_tpu.circuit import recursive_verifier as ref_rv  # noqa: E402
from plonky2_ecdsa_tpu.curve import native as ref_cn  # noqa: E402
from plonky2_ecdsa_tpu.prover import data as ref_data_mod  # noqa: E402
from plonky2_ecdsa_tpu.prover import prover as ref_prover  # noqa: E402
from plonky2_ecdsa_tpu_torch import api  # noqa: E402
from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv  # noqa: E402
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig  # noqa: E402
from plonky2_ecdsa_tpu_torch.circuit.examples import (recursion_demo_inputs,  # noqa: E402
                                                      small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl  # noqa: E402
from plonky2_ecdsa_tpu_torch.prover import prover  # noqa: E402
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data  # noqa: E402
from plonky2_ecdsa_tpu_torch.utils.debug import (gate_histogram, gate_rows_used,  # noqa: E402
                                                 structure_digest, value_table_digest)
from test_torch_bridge import from_reference_proof, pair_to_u64  # noqa: E402
from test_torch_recursive_proof import (DEMO_BATCH as REC_BATCH, DEMO_SEED as REC_SEED,  # noqa: E402
                                        OUTER, port_inner, ref_inner_circuit, ref_outer_circuit)

ANCHORS = os.path.join(ROOT, "plonky2_ecdsa_tpu_torch", "vectors", "anchors.json")
DEMO_BATCH = 2
SEED = 3
# Test processes run side by side: with a thread per core in each of them the
# full-width fixed commit below spends minutes spinning on oversubscribed cores.
torch.set_num_threads(2)


def _hex(a) -> list:
    return [f"{int(v):016x}" for v in np.asarray(a, np.uint64).ravel()]


def reference_demo_digest() -> str:
    """sha256 over the leaves of the reference's numpy proof of the demo
    circuit at B=2 (the demo witness is seeded by the batch size)."""
    c = ref_examples.small_demo_circuit().build()
    os.environ["PLONKY2_TPU_HOST_BUILD"] = "1"
    data = ref_data_mod.build_circuit_data(c)
    W, pis = ref_examples.small_demo_witness(c, DEMO_BATCH)
    return prover.proof_digest(from_reference_proof(ref_prover.prove(data, W, pis)))


def reference_demo_recursion() -> dict:
    """Anchor (a): the demo inner proof (B=2, seed 77) through its verifier
    circuit under the demo outer config, in the reference's numpy path."""
    os.environ["PLONKY2_TPU_HOST_BUILD"] = "1"
    t0 = time.time()
    ic = ref_inner_circuit()
    W = ic.generate_witness(recursion_demo_inputs(REC_BATCH, REC_SEED), REC_BATCH)
    idata = ref_data_mod.build_circuit_data(ic)
    iproof = ref_prover.prove(idata, W, ic.public_input_values())
    oc = ref_outer_circuit(idata)
    vals = oc._run_tape(ref_rv.recursive_verifier_inputs(idata, iproof), REC_BATCH, None)
    opis = oc.public_input_values()
    odata = ref_data_mod.build_circuit_data(oc)
    Wo = np.zeros((oc.config.num_wires, oc.n, REC_BATCH), np.uint64)
    Wo[oc.pos_cols, oc.pos_rows] = vals[oc.pos_tids]
    proof = from_reference_proof(ref_prover.prove(odata, Wo, opis))
    print(f"demo recursion (numpy): {time.time() - t0:.1f} s", flush=True)
    return {"recursion_demo_batch": REC_BATCH, "recursion_demo_seed": REC_SEED,
            "recursion_demo_fixed_cap": _hex(pair_to_u64(odata.fixed_tree.cap)),
            "recursion_demo_table_sha256": value_table_digest(vals),
            "recursion_demo_lane0_proof_sha256": prover.proof_digest(proof, lane=0)}


def reference_production_outer(idata) -> dict:
    """Anchor (b): the verifier circuit of the secp256k1 circuit (its fixed
    data `idata`) under recursion_ecc_config: structure and fixed cap."""
    os.environ["PLONKY2_TPU_HOST_BUILD"] = "1"
    t0 = time.time()
    oc = ref_outer_circuit(idata, CircuitConfig.recursion_ecc_config())
    print(f"production verifier circuit build: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    odata = ref_data_mod.build_circuit_data(oc)
    print(f"production verifier circuit fixed commit (numpy): {time.time() - t0:.1f} s", flush=True)
    return {"recursion_ecc_n": oc.n, "recursion_ecc_rows": gate_rows_used(oc),
            "recursion_ecc_gates": gate_histogram(oc),
            "recursion_ecc_structure_sha256": structure_digest(oc),
            "recursion_ecc_fixed_cap": _hex(pair_to_u64(odata.fixed_tree.cap))}


def port_production_outer(system):
    """The port's verifier circuit of its secp256k1 system's circuit."""
    return rv.verifier_circuit(system.data, CircuitConfig.recursion_ecc_config())


def make_anchors() -> dict:
    """Every frozen value, from the reference's numpy path."""
    os.environ["PLONKY2_TPU_HOST_BUILD"] = "1"
    out = {"demo_batch": DEMO_BATCH, "seed": SEED,
           "demo_proof_sha256": reference_demo_digest()}
    for name, curve in (("secp256k1", ref_cn.SECP256K1), ("p256", ref_cn.P256)):
        t0 = time.time()
        system = ref_api.EcdsaProverSystem(curve)
        data = system.data
        out[f"{name}_n"] = data.n
        out[f"{name}_fixed_cap"] = _hex(pair_to_u64(data.fixed_tree.cap))
        print(f"{name} fixed commit: {time.time() - t0:.1f} s", flush=True)
        stmts = ref_api.random_statements(curve, 1, seed=SEED)
        W, pis = system.witness(stmts)
        wires, pi, pis_pair = ref_prover.host_prep(data, W, pis)
        t0 = time.time()
        cap = ref_prover.prove_core(data, ref_prover.Backend(data, np), wires, pi, pis_pair, np,
                                    stop_after="commit")
        out[f"{name}_lane0_wires_cap"] = _hex(pair_to_u64(cap)[0])
        print(f"{name} wires commit B=1: {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        proof = from_reference_proof(ref_prover.prove(data, W, pis))
        out[f"{name}_lane0_proof_sha256"] = prover.proof_digest(proof, lane=0)
        print(f"{name} numpy prove B=1: {time.time() - t0:.1f} s", flush=True)
        if name == "secp256k1":
            out.update(reference_production_outer(data))
    out.update(reference_demo_recursion())
    return out


@pytest.fixture(scope="module")
def anchors():
    with open(ANCHORS) as f:
        return json.load(f)


def test_anchor_file_is_whole(anchors):
    assert anchors["demo_batch"] == DEMO_BATCH and anchors["seed"] == SEED
    assert len(anchors["demo_proof_sha256"]) == 64
    for curve in ("secp256k1", "p256"):
        assert anchors[f"{curve}_n"] == 1 << 13
        for name in (f"{curve}_fixed_cap", f"{curve}_lane0_wires_cap"):
            words = [int(v, 16) for v in anchors[name]]
            assert len(words) == 4 << 4 and all(0 <= w < gl.P for w in words), name   # cap_height 4
        assert len(anchors[f"{curve}_lane0_proof_sha256"]) == 64
    assert anchors["p256_fixed_cap"] != anchors["secp256k1_fixed_cap"]
    assert (anchors["recursion_demo_batch"], anchors["recursion_demo_seed"]) == (REC_BATCH, REC_SEED)
    assert len(anchors["recursion_demo_fixed_cap"]) == 4 << 1                       # cap_height 1
    assert len(anchors["recursion_ecc_fixed_cap"]) == 4 << 4
    for name in ("recursion_demo_table_sha256", "recursion_demo_lane0_proof_sha256",
                 "recursion_ecc_structure_sha256"):
        assert len(anchors[name]) == 64, name
    assert anchors["recursion_ecc_n"] == 1 << 14
    assert sum(anchors["recursion_ecc_gates"].values()) == 1 << 14


def test_demo_anchor_is_the_references_proof(anchors):
    assert reference_demo_digest() == anchors["demo_proof_sha256"]


def test_port_demo_proof_meets_the_anchor(anchors):
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    proof = prover.prove(data, *small_demo_witness(c, DEMO_BATCH))
    assert prover.proof_digest(proof) == anchors["demo_proof_sha256"]
    assert prover.proof_digest(proof, lane=0) != prover.proof_digest(proof, lane=1)


@pytest.fixture(scope="module")
def secp256k1():
    return api.EcdsaProverSystem(api.SECP256K1, device="cpu")


def test_port_fixed_commit_meets_the_anchor(anchors, secp256k1):
    """The port's own secp256k1 build and fixed commit, on the CPU through the
    plain kernels, give the reference's fixed cap."""
    assert _hex(gl.to_u64(secp256k1.data.fixed_tree.cap)) == anchors["secp256k1_fixed_cap"]


def test_port_demo_recursion_meets_the_anchor(anchors):
    """The port's demo inner proof, verifier circuit, value table, outer fixed
    commit and outer proof (lane 0), on the CPU."""
    _ic, idata, iproof = port_inner(REC_BATCH, REC_SEED)
    oc = rv.verifier_circuit(idata, OUTER)
    vals = oc.value_table(rv.recursive_verifier_inputs(idata, iproof), REC_BATCH)
    assert value_table_digest(vals) == anchors["recursion_demo_table_sha256"]
    odata = build_circuit_data(oc, "cpu")
    assert _hex(gl.to_u64(odata.fixed_tree.cap)) == anchors["recursion_demo_fixed_cap"]
    proof = prover.Prover(odata).run_vals(vals, oc.public_input_values())
    assert prover.proof_digest(proof, lane=0) == anchors["recursion_demo_lane0_proof_sha256"]


@pytest.fixture(scope="module")
def production_outer(secp256k1):
    return port_production_outer(secp256k1)


def test_port_production_outer_circuit_meets_the_anchor(anchors, production_outer):
    oc = production_outer
    assert (oc.n, gate_rows_used(oc), gate_histogram(oc)) == \
        (anchors["recursion_ecc_n"], anchors["recursion_ecc_rows"], anchors["recursion_ecc_gates"])
    assert structure_digest(oc) == anchors["recursion_ecc_structure_sha256"]


@pytest.mark.slow
def test_port_production_outer_fixed_cap_meets_the_anchor(anchors, production_outer):
    odata = build_circuit_data(production_outer, "cpu")
    assert _hex(gl.to_u64(odata.fixed_tree.cap)) == anchors["recursion_ecc_fixed_cap"]


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    made = make_anchors()
    os.makedirs(os.path.dirname(ANCHORS), exist_ok=True)
    with open(ANCHORS, "w") as f:
        json.dump(made, f, indent=1)
        f.write("\n")
    print(f"wrote {ANCHORS}")
