"""Small demo circuits: CPU-fast shapes that still exercise the whole
gadget + prover stack (used by unit tests, the graft entry point, and the
multichip dry run); and the demo recursion's setting (its inner circuit,
inputs and configs), which the tests and the GPU smoke run share."""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks_host as gl
from .builder import CircuitBuilder
from .config import CircuitConfig, FriConfig

P = gl.P


def small_demo_circuit(config: CircuitConfig | None = None) -> CircuitBuilder:
    """A few-row circuit touching arithmetic, split, range-check,
    random-access, and select gadgets (mirrors the shape of the reference's
    per-gadget unit tests, SURVEY.md §4)."""
    b = CircuitBuilder(config or CircuitConfig.test_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    z = b.mul(x, y)
    w = b.mul_add(z, z, y)
    bits = b.split_le_base2(x, 29)
    b.range_check(x, 29)
    v = b.random_access(bits[0], [b.constant(i * i) for i in range(16)])
    eq = b.is_equal(x, y)
    out = b.select(eq, z, w)
    b.register_public_inputs([z, w, out, v])
    return b


def small_demo_witness(circuit, batch: int, seed: int = 42):
    """(W, pis) for a random batch on the small demo circuit."""
    rng = np.random.default_rng(seed + batch)
    xs = rng.integers(0, 1 << 29, size=(batch, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(batch, 1), dtype=np.uint64) % np.uint64(P)
    W = circuit.generate_witness({"x": xs, "y": ys}, batch)
    return W, circuit.public_input_values()


def recursion_demo_configs() -> tuple:
    """(inner, outer, aggregation) configs of the demo recursion, the setting
    of the reference's tests/test_recursive_proof.py: a small inner shape
    (final_poly_max_degree_bits=2 forces FRI fold layers), and for the
    verifier circuits rate 8 (PoseidonGate is degree 7) with reduced FRI."""
    inner = CircuitConfig(num_wires=16, num_routed_wires=8, num_constant_cols=4,
                          range_lookup_limb_bits=3, range_lookup_vals=1, num_challenges=1,
                          permutation_chunk_size=4,
                          fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                                        proof_of_work_bits=4, final_poly_max_degree_bits=2))
    outer = CircuitConfig(num_wires=136, num_routed_wires=80, num_constant_cols=2,
                          range_lookup_limb_bits=3,
                          fri=FriConfig(rate_bits=3, cap_height=1, num_query_rounds=8,
                                        proof_of_work_bits=4))
    agg = CircuitConfig(num_wires=136, num_routed_wires=80, num_constant_cols=2,
                        range_lookup_limb_bits=3,
                        fri=FriConfig(rate_bits=3, cap_height=1, num_query_rounds=3,
                                      proof_of_work_bits=2, final_poly_max_degree_bits=5))
    return inner, outer, agg


def recursion_demo_inner(b: CircuitBuilder | None = None):
    """The demo recursion's inner circuit, built: x*y, a mul-add, is_equal,
    select and a 29-bit range check, with PIs (z, w, out).  `b` is an empty
    builder to fill (default: one under the demo inner config)."""
    b = b or CircuitBuilder(recursion_demo_configs()[0])
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    z = b.mul(x, y)
    w = b.mul_add(z, z, y)
    out = b.select(b.is_equal(x, y), z, w)
    b.range_check(x, 29)
    b.register_public_inputs([z, w, out])
    return b.build()


def recursion_demo_inputs(batch: int, seed: int) -> dict:
    """Seeded inputs of the demo inner circuit: x below 2^29, y any field element."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1 << 29, size=(batch, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(batch, 1), dtype=np.uint64) % np.uint64(P)
    return {"x": xs, "y": ys}


def nonnative_mul_chain_circuit(num_muls: int = 11,
                                config: CircuitConfig | None = None) -> CircuitBuilder:
    """Chain of nonnative secp256k1 base-field muls (the reference's
    test_nonnative_mul shape, src/gadgets/nonnative.rs:955-984; 11 chained
    muls per build) — the microbench circuit for nonnative muls/sec."""
    from .foreign import secp256k1_base
    from ..gadgets import nonnative as gn

    b = CircuitBuilder(config or CircuitConfig.test_config())
    ff = secp256k1_base()
    x = gn.add_virtual_nonnative(b, ff)
    y = gn.add_virtual_nonnative(b, ff)
    b.register_input("x", x.limbs)
    b.register_input("y", y.limbs)
    acc = gn.mul_nonnative(b, x, y, False)
    for _ in range(num_muls - 2):
        acc = gn.mul_nonnative(b, acc, y, False)
    acc = gn.mul_nonnative(b, acc, y, True)
    b.register_public_inputs(acc.limbs)
    return b
