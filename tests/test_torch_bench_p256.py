"""The benchmark's P-256 configuration (benchmark/configs/p256_ecdsa.json)
against the program, on the CPU, and the Z stage's split into its
permutation and LogUp parts:

  (a) the frozen ``circuit`` entry is what the program builds today, and its
      verifying key is the anchor the reference package froze;
  (b) every gate of the P-256 circuit evaluates the same in the benchmark's
      plain reference (``benchmark/ref/gates.py``) as in the program;
  (c) the benchmark's P-256 statements verify, a flipped message does not,
      and their public inputs are the program's;
  (d) a small circuit of P-256 base-field gadgets under P-256's constant and
      range-lookup widths, proved by the program at B=2, is accepted lane by
      lane by the reference verifier, and a lane with an altered public
      input, wires cap or proof-of-work witness is rejected;
  (e) the front records ``zs_perm`` before ``zs_vals``, the LogUp counter
      follows each circuit's layout, and the demo proof is unchanged;
  (f) the readers ``zs_perm_ms`` and ``zs_lookup_ms`` on synthetic tracer
      records: the window's batches only, and nothing to read from a
      program without the ``zs_perm`` stamp;
  (g) the native witness tape's nonnative inversion, one modular inverse
      shared by the lanes, writes the numpy tape's values on edge operands
      (zero, the modulus, values above it) at odd batch sizes.

Like the benchmark's own tests, this file imports neither JAX nor the JAX
package."""

import collections
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import ecdsa, proofs, traffic
from benchmark.ref import field as f
from benchmark.ref import gates as rg
from benchmark.ref import verifier
from benchmark.ref.circuit import Common
from benchmark.run import HERE, Cell
from benchmark.selftest.test_bench_reference import entry_of
from benchmark.tools import freeze_circuit
from plonky2_ecdsa_tpu_torch import api, trace
from plonky2_ecdsa_tpu_torch.circuit.builder import CircuitBuilder
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.circuit.foreign import p256_base, secp256k1_scalar
from plonky2_ecdsa_tpu_torch.gadgets import nonnative as gn
from plonky2_ecdsa_tpu_torch.prover import data as data_mod
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

torch.set_num_threads(2)
ANCHORS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "plonky2_ecdsa_tpu_torch", "vectors", "anchors.json")


def _spec() -> dict:
    with open(os.path.join(freeze_circuit.CONFIGS, "p256_ecdsa.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def p256():
    """(spec, circuit, data) of the configuration, as the program builds it."""
    spec = _spec()
    circuit, data = freeze_circuit.build(spec)
    return spec, circuit, data


# ---------------------------------------------------------------------------
# (a) the frozen configuration
# ---------------------------------------------------------------------------

def test_the_frozen_p256_circuit_is_the_programs_build(p256, monkeypatch):
    spec, circuit, data = p256
    assert (spec["driver"], spec["curve"], spec["circuit_config"], spec["anchor"]) == (
        "flat_ecdsa", "p256", "p256_ecc_config", "p256_fixed_cap")
    assert spec["reduced"] == [] and circuit.n == 1 << 13
    monkeypatch.setattr(freeze_circuit, "build", lambda s, device="cpu": (circuit, data))
    assert freeze_circuit.entry(spec) == spec["circuit"]


# ---------------------------------------------------------------------------
# (b) the reference's gates
# ---------------------------------------------------------------------------

def test_every_p256_gate_against_the_programs_gates(p256):
    from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchExtAlgebra
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    _spec, circuit, _data = p256
    g = np.random.default_rng(15)
    L = 3

    def rand(k):
        return [tuple(g.integers(0, 2**63, L, dtype=np.uint64) for _ in range(2)) for _ in range(k)]

    def up(e):
        return (gl.from_u64(e[0], "cpu"), gl.from_u64(e[1], "cpu"))

    ids = [gate.gate_id() for gate in circuit.gates]
    assert {"Constant(64)", "MulNonNative(p256_base)", "MulNonNative(p256_scalar)",
            "NonNativeAdd(p256_base,2)", "NonNativeSub(p256_base,2)",
            "NonNativeAddMany(p256_base,4)", "RangeLookup(29,31,13)",
            "RangeLookup(34,31,13)"} <= set(ids)
    for gate in circuit.gates:
        w = rand(max(gate.num_wires, 1))
        c, pv = rand(circuit.config.num_constant_cols), rand(8)
        theirs = gate.eval(TorchExtAlgebra((L,), "cpu"), [up(x) for x in w], [up(x) for x in c],
                           {"pi_vals": [up(x) for x in pv]})
        mine = rg.parse(gate.gate_id()).eval(f.ExtAlgebra((L,)), w, c, {"pi_vals": pv})
        assert len(mine) == len(theirs) == gate.num_constraints, gate.gate_id()
        for x, y in zip(mine, theirs):
            assert (x[0] == gl.to_u64(y[0])).all() and (x[1] == gl.to_u64(y[1])).all(), gate.gate_id()


# ---------------------------------------------------------------------------
# (c) the statements
# ---------------------------------------------------------------------------

def test_p256_statements_and_their_public_inputs():
    mix = {"batch": 3, "pool_batches": 2, "in_flight": 2}
    pool = traffic.statement_pool("p256", mix, 2**33 + 15)
    assert pool == traffic.statement_pool("p256", mix, 2**33 + 15)
    assert pool != traffic.statement_pool("p256", mix, 2**33 + 16)
    c = ecdsa.CURVES["p256"]
    assert all(ecdsa.verify(c, st) for b in pool for st in b)
    for st in (pool[0][0], pool[1][2]):
        assert not ecdsa.verify(c, ecdsa.Statement(st.msg ^ 1, st.r, st.s, st.pk))
        theirs = api.statement_pis(api.EcdsaStatement(msg=st.msg, r=st.r, s=st.s,
                                                      pk=api.cn.Point(api.P256, *st.pk)))
        assert [int(v) for v in theirs] == ecdsa.public_inputs(st)


# ---------------------------------------------------------------------------
# (d) a proof of P-256 gadgets through the reference verifier
# ---------------------------------------------------------------------------

GADGETS = CircuitConfig(num_constant_cols=64, range_lookup_vals=31, range_lookup_limb_bits=3,
                        fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=12,
                                      proof_of_work_bits=8))


@pytest.fixture(scope="module")
def gadgets():
    """P-256 base-field mul, add, sub and add_many, each range-checked, at
    B=2: (the reference's view of the circuit, the proof's arrays)."""
    b = CircuitBuilder(GADGETS)
    ff = p256_base()
    x, y = gn.add_virtual_nonnative(b, ff), gn.add_virtual_nonnative(b, ff)
    b.register_input("x", x.limbs)
    b.register_input("y", y.limbs)
    m = gn.mul_nonnative(b, x, y, True)
    s = gn.add_nonnative(b, m, x, True)
    d = gn.sub_nonnative(b, s, y, True)
    b.register_public_inputs(gn.add_many_nonnative(b, [m, s, d, x], True).limbs)
    c = b.build()
    data = build_circuit_data(c, "cpu")
    g = np.random.default_rng(256)
    p = ecdsa.CURVES["p256"].p
    xs, ys = ([int.from_bytes(g.bytes(40), "little") % p for _ in range(2)] for _ in range(2))
    W = c.generate_witness({"x": api.int_to_limbs(xs), "y": api.int_to_limbs(ys)}, 2)
    pis = c.public_input_values()
    for lane, (xv, yv) in enumerate(zip(xs, ys)):
        mv = xv * yv % p
        sv = (mv + xv) % p
        dv = (sv - yv) % p
        assert api.limbs_to_int(pis[lane:lane + 1, :9]) == [(mv + sv + dv + xv) % p]
    return c, Common(entry_of(c, data)), proofs.arrays(prover.prove(data, W, pis))


def test_a_p256_gadget_proof_is_accepted_lane_by_lane(gadgets):
    c, common, proof = gadgets
    ids = {g.gate_id() for g in c.gates}
    assert {"Constant(64)", "MulNonNative(p256_base)", "NonNativeAdd(p256_base,2)",
            "NonNativeSub(p256_base,2)", "NonNativeAddMany(p256_base,4)"} <= ids
    assert common.lookup is not None
    assert verifier.accepted(verifier.verify(common, proof)).tolist() == [True, True]


@pytest.mark.parametrize("alter", ["pis", "wires_cap", "pow"])
def test_a_p256_gadget_lane_altered_is_rejected(gadgets, alter):
    _c, common, proof = gadgets
    p = proofs.lanes([(proof, [0, 1])])                 # a copy
    if alter == "pis":
        p["pis"][1, 0] ^= np.uint64(1)
    elif alter == "wires_cap":
        p["wires_cap"][1, 0, 0] ^= np.uint64(1)
    else:
        p["pow_witness"][1] ^= np.uint64(1)
    assert verifier.accepted(verifier.verify(common, p)).tolist() == [True, False]


# ---------------------------------------------------------------------------
# (e) the Z stage's split and the LogUp counter
# ---------------------------------------------------------------------------

def _counts(circuit) -> dict:
    """lookup_counts of a circuit's layout, without its fixed commit."""
    return prover.lookup_counts(SimpleNamespace(circuit=circuit,
                                                lookup=data_mod._lookup_info(circuit)))


def test_the_front_stamps_zs_perm_before_zs_vals_and_the_demo_proof_holds():
    trace.enable()
    trace.clear()
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    run = prover.Prover(data)
    proof = run.collect(run.dispatch(*small_demo_witness(c, 2)))
    front = [s for s in trace.batches()[-1].stages if s.part == "front"]
    names = [s.name for s in front]
    assert names == ["expand", "commit", "challenges", "zs_perm", "zs_vals", "zs", "alphas"]
    perm, vals = front[3], front[4]
    assert perm.start <= perm.end <= vals.start <= vals.end
    with open(ANCHORS) as fh:
        assert prover.proof_digest(proof) == json.load(fh)["demo_proof_sha256"]
    lk = data.lookup
    assert prover.lookup_counts(data) == dict(
        challenges=c.config.num_challenges, batches=lk.num_batches, gates=len(lk.gates),
        denominators=c.config.num_challenges * (len(lk.gates) * lk.num_batches + 1))
    # the graphs' set-up figures carry it (the capture itself runs on the card only)
    part = SimpleNamespace(capture_s=0.0, instantiate_s=0.0, nodes=1,
                           launches=collections.Counter())
    stub = SimpleNamespace(front=part, chunk=part, back=part, domain=[0], warmup_s=0.0,
                           host_bytes=0, device_bytes=0, lookup=prover.lookup_counts(data))
    assert prover._CapturedProve.stats(stub)["lookup"] == prover.lookup_counts(data)


def test_the_lookup_counter_follows_each_circuits_layout(p256):
    _spec, _circuit, data = p256
    assert prover.lookup_counts(data) == dict(challenges=2, batches=42, gates=2,
                                              denominators=170)
    secp = api.EcdsaProverSystem(api.SECP256K1, device="cpu").circuit
    assert _counts(secp) == dict(challenges=2, batches=38, gates=2, denominators=154)
    no_lookups = SimpleNamespace(circuit=None, lookup=None)
    assert prover.lookup_counts(no_lookups) == dict(challenges=0, batches=0, gates=0,
                                                    denominators=0)


# ---------------------------------------------------------------------------
# (f) the readers of the split
# ---------------------------------------------------------------------------

MS = 1_000_000          # ns


def _batch(seq: int, t: int, perm, vals: int) -> trace.Batch:
    """A batch dispatched at t ms whose front is expand 5 ms, then `perm` ms
    of zs_perm (None: a program without the stamp), then `vals` ms of
    zs_vals, then the zs commit 7 ms."""
    names = [("expand", 5)] + ([("zs_perm", perm)] if perm is not None else []) + [
        ("zs_vals", vals), ("zs", 7)]
    st, c = [], t
    for name, ms in names:
        st.append(trace.Stage("front", name, c * MS, (c + ms) * MS))
        c += ms
    return trace.Batch("vals", 32, seq, (t * MS, (t + 1) * MS), (c * MS, (c + 1) * MS), (),
                       tuple(st))


def _readers():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = Cell(bench, "p256_ecdsa.b32", 1)
    assert {"zs_perm_ms", "zs_lookup_ms"} <= {m["name"] for m in cell.metrics["per_layer"]}
    return cell.module("metrics", "zs_perm_ms"), cell.module("metrics", "zs_lookup_ms")


LOOKUP = dict(challenges=2, batches=42, gates=2, denominators=170)


@pytest.mark.parametrize("program", ["split", "parent", "no_lookups"])
def test_the_split_readers_on_tracer_records(program, monkeypatch):
    from benchmark import stages
    perm_ms, lookup_ms = _readers()
    lookup = dict(LOOKUP) if program != "no_lookups" else dict.fromkeys(LOOKUP, 0)
    perm = None if program == "parent" else 100
    setup = _batch(0, 0, None if perm is None else 900, 900)
    window = [_batch(1, 1000, perm, 170), _batch(2, 1400, perm and perm + 20, 340)]
    traced = [_batch(3, 3000, None if perm is None else 900, 900)]
    monkeypatch.setattr(stages, "program_trace", lambda: ([setup, *window, *traced], []))
    run = SimpleNamespace(records=[{"t0": 0.99, "t3": 2.0}], graph_stats={"lookup": lookup})
    if program == "parent":
        assert perm_ms.read(run) is None and lookup_ms.read(run) is None
        assert perm_ms.extra(run) == {} and lookup_ms.extra(run) == {}
        return
    assert perm_ms.read(run) == 110.0 and perm_ms.extra(run) == {"batches": 2}
    assert lookup_ms.read(run) == 255.0
    extra = lookup_ms.extra(run)
    assert extra["batches"] == 2
    assert {k: extra[f"lookup.{k}"] for k in LOOKUP} == lookup
    if program == "split":
        assert extra["ms_per_denominator"] == pytest.approx(1.5)
    else:
        assert "ms_per_denominator" not in extra


# ---------------------------------------------------------------------------
# (g) the native tape's shared inversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", [p256_base, secp256k1_scalar])
@pytest.mark.parametrize("lanes", [1, 2, 9])
def test_native_inversion_equals_the_numpy_tape(field, lanes):
    ff = field()
    b = CircuitBuilder(CircuitConfig.test_config())
    x = gn.add_virtual_nonnative(b, ff)
    b.register_input("x", x.limbs)
    b.register_public_inputs(gn.inv_nonnative(b, x, False).limbs)
    c = b.build()
    g = np.random.default_rng(lanes)
    edge = [0, 1, ff.m - 1, ff.m, ff.m + 1, 2 * ff.m, (1 << 261) - 1]
    xs = (edge + [int.from_bytes(g.bytes(33), "little") % (1 << 261)
                  for _ in range(lanes)])[:lanes]
    inputs = {"x": api.int_to_limbs(xs)}
    native = c.value_table(inputs, lanes, native=True)
    assert c.last_tape_native
    assert np.array_equal(native, c.value_table(inputs, lanes, native=False))
    got = api.limbs_to_int(c.public_input_values()[:, :9])
    assert got == [pow(v, -1, ff.m) if v % ff.m else 0 for v in xs]
