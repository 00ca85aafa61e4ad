"""The port's own host layers against the reference's, on the CPU, seeded
with numpy, tolerance 0 (the arithmetic is exact): circuit build, witness,
random statements, fixed data, and the state carried across by
``circuit_data_from_reference``."""

import numpy as np
import pytest

from plonky2_ecdsa_tpu import api as ref_api
from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.circuit.config import CircuitConfig as RefConfig
from plonky2_ecdsa_tpu.circuit.config import FriConfig as RefFri
from plonky2_ecdsa_tpu.curve import native as ref_cn
from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.fields import limbs as ref_limbs
from plonky2_ecdsa_tpu.fields import prime_field as ref_prime_field
from plonky2_ecdsa_tpu.hash.keccak import keccak256 as ref_keccak256
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import fri as ref_fri
from plonky2_ecdsa_tpu.prover import ntt as ref_ntt
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch import api
from plonky2_ecdsa_tpu_torch.circuit import examples
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa_tpu_torch.circuit.witness import check_constraints
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.fields import goldilocks_host as glh
from plonky2_ecdsa_tpu_torch.fields import limbs, prime_field
from plonky2_ecdsa_tpu_torch.hash.keccak import keccak256
from plonky2_ecdsa_tpu_torch.prover import data as data_mod
from plonky2_ecdsa_tpu_torch.prover import fri, ntt, ntt_cuda, prover
from test_torch_bridge import (from_reference_proof, pair_to_u64, reference_data_arrays,
                               same_circuit)

_FRI = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=8,
            final_poly_max_degree_bits=2)
FOLDING = CircuitConfig(range_lookup_limb_bits=3, fri=FriConfig(**_FRI))
REF_FOLDING = RefConfig(range_lookup_limb_bits=3, fri=RefFri(**_FRI))


def _nonnative_inputs():
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    return {"x": api.int_to_limbs(xs), "y": api.int_to_limbs(ys)}


@pytest.fixture(scope="module")
def demo():
    return ref_examples.small_demo_circuit().build(), examples.small_demo_circuit().build()


@pytest.fixture(scope="module")
def nonnative():
    return (ref_examples.nonnative_mul_chain_circuit(config=REF_FOLDING).build(),
            examples.nonnative_mul_chain_circuit(config=FOLDING).build())


@pytest.fixture(scope="module")
def secp():
    return ref_api.EcdsaProverSystem(ref_cn.SECP256K1), api.EcdsaProverSystem(cn.SECP256K1, device="cpu")


# ---------------------------------------------------------------------------
# constants and small tables
# ---------------------------------------------------------------------------

def test_field_constants_equal_reference():
    for name in ("P", "W_EXT", "MULTIPLICATIVE_GROUP_GENERATOR", "TWO_ADICITY",
                 "POWER_OF_TWO_GENERATOR"):
        assert getattr(glh, name) == getattr(ref_gl, name) == getattr(gl, name), name
    assert ntt.COSET_SHIFT == ref_ntt.COSET_SHIFT
    assert ntt_cuda.FOUR_STEP_MIN == ref_ntt._FOUR_STEP_MIN
    assert pow(glh.root_of_unity(1 << 13), 1 << 12, glh.P) == glh.P - 1


def test_host_field_equals_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(0, glh.P, 4096, dtype=np.uint64)
    b = rng.integers(0, glh.P, 4096, dtype=np.uint64)
    a[:4] = [0, 1, glh.P - 1, glh.P - 1]
    b[:4] = [0, glh.P - 1, glh.P - 1, 1]
    pa, pb = ref_gl.from_u64(a), ref_gl.from_u64(b)
    for name in ("add", "sub", "mul"):
        assert np.array_equal(getattr(glh, name)(a, b),
                              ref_gl.to_u64(*getattr(ref_gl, name)(*pa, *pb))), name
    assert np.array_equal(glh.neg(a), ref_gl.to_u64(*ref_gl.neg(*pa)))
    assert np.array_equal(glh.inverse(a[:64]), ref_gl.to_u64(*ref_gl.inverse(pa[0][:64], pa[1][:64])))
    assert np.array_equal(glh.mul_const(a, 12345), glh.mul(a, np.uint64(12345)))
    assert glh.geometric(3, 5, 4).tolist() == [3, 15, 75, 375]


@pytest.mark.parametrize("n", [8, 64, 1 << 10, 1 << 12])
def test_ntt_tables_equal_reference(n):
    for inverse in (False, True):
        want = ref_ntt._twiddles(n, inverse)
        got = ntt_cuda.twiddles(n, inverse, "cpu")
        assert np.array_equal(gl.to_u64(got), np.concatenate(want))
        assert np.array_equal(gl.to_u64(ntt.coset_powers(n, inverse, "cpu")),
                              ref_ntt._coset_powers(n, inverse))
        if n >= ntt_cuda.FOUR_STEP_MIN:
            T = pair_to_u64(ref_ntt._four_step_T(n, inverse))
            if inverse:
                T = glh.mul_const(T, pow(n, -1, glh.P))
            assert np.array_equal(gl.to_u64(ntt_cuda.four_step_T(n, inverse, "cpu")), T)
    assert np.array_equal(ntt_cuda._bitrev(n, "cpu").numpy(), ref_ntt._bitrev(n))
    assert ntt_cuda._split2(n) == ref_ntt._split2(n)
    assert np.array_equal(ntt.lde_domain(n), ref_ntt.lde_domain(n))


@pytest.mark.parametrize("N,final_bits", [(32, 2), (256, 2), (1 << 15, 5)])
def test_fri_plan_and_domain_tables_equal_reference(N, final_bits):
    cfg = CircuitConfig(fri=FriConfig(**{**_FRI, "final_poly_max_degree_bits": final_bits}))
    plan = fri.plan(N, cfg)
    assert plan == ref_fri.plan(N, cfg)
    num_layers = plan[0]
    want, want_shift = ref_fri._domain_tables(N, num_layers)
    layers, final_shift = fri._domain_tables(N, num_layers)
    assert final_shift == want_shift
    assert layers == [(s, g) for s, g, _t in want]
    inv2x, spow = fri.domain_tables(N, num_layers, "cpu")
    for got, (_s, _g, t) in zip(inv2x, want):
        assert np.array_equal(gl.to_u64(got), t)
    size = N >> num_layers
    assert gl.to_u64(spow).tolist() == [pow(want_shift, -i, glh.P) for i in range(size)]


def test_limbs_engine_equals_reference():
    rng = np.random.default_rng(2)
    m = cn.SECP256K1.p
    mod, ref_mod = limbs.Modulus(m, "p"), ref_limbs.Modulus(m, "p")
    xs = [int.from_bytes(rng.bytes(32), "little") % m for _ in range(6)]
    ys = [int.from_bytes(rng.bytes(32), "little") % m for _ in range(6)]
    a, b = limbs.from_ints(xs, mod.L), limbs.from_ints(ys, mod.L)
    for name in ("mod_mul", "mod_add", "mod_sub"):
        got, want = getattr(mod, name)(a, b), getattr(ref_mod, name)(a, b)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), name
    q, r = mod.mod_mul(a, b)
    assert limbs.to_ints(r).tolist() == [x * y % m for x, y in zip(xs, ys)]
    assert np.array_equal(limbs.convert(r, 16, 29, 9), ref_limbs.convert(r, 16, 29, 9))
    inv, _ = mod.mod_inv(a)
    assert limbs.to_ints(inv).tolist() == [pow(x, -1, m) for x in xs]


@pytest.mark.parametrize("name", ["P256Base", "P256Scalar", "Secp256K1Base", "Secp256K1Scalar"])
def test_prime_field_classes_equal_reference(name):
    F, R = getattr(prime_field, name), getattr(ref_prime_field, name)
    for const in ("ORDER", "BITS", "TWO_ADICITY", "MULTIPLICATIVE_GROUP_GENERATOR",
                  "POWER_OF_TWO_GENERATOR"):
        assert getattr(F, const) == getattr(R, const), const
    rng = np.random.default_rng(11)
    a, b = (int.from_bytes(rng.bytes(40), "little") for _ in range(2))
    x, y, rx, ry = F(a), F(b), R(a), R(b)
    assert ((x + y).v, (x - y).v, (x * y).v, (-x).v, x.inverse().v, x.exp(65537).v) == \
        ((rx + ry).v, (rx - ry).v, (rx * ry).v, (-rx).v, rx.inverse().v, rx.exp(65537).v)
    assert (x * x.inverse()).v == 1 and F.from_u64_limbs(x.to_u64_limbs()) == x
    assert pow(F.POWER_OF_TWO_GENERATOR, 1 << F.TWO_ADICITY, F.ORDER) == 1


@pytest.mark.parametrize("data", [b"", b"abc", bytes(range(200)), b"\x00" * 136])
def test_keccak256_equals_reference(data):
    assert keccak256(data) == ref_keccak256(data)
    if data == b"abc":
        assert keccak256(data).hex() == \
            "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"


def test_curve_layer_equals_reference():
    for name in ("p", "n", "a", "b"):
        assert getattr(cn.SECP256K1, name) == getattr(ref_cn.SECP256K1, name)
    sk, msg, nonce = 0x1234567, 0xABCDEF, 0x777
    _, pk = cn.keygen(cn.SECP256K1, sk)
    _, ref_pk = ref_cn.keygen(ref_cn.SECP256K1, sk)
    assert (pk.x, pk.y) == (ref_pk.x, ref_pk.y)
    sig = cn.sign_message(cn.SECP256K1, msg, sk, nonce)
    assert sig == ref_cn.sign_message(ref_cn.SECP256K1, msg, sk, nonce)
    assert cn.verify_message(cn.SECP256K1, msg, *sig, pk)
    assert not cn.verify_message(cn.SECP256K1, msg + 1, *sig, pk)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_statements_equal_reference(seed):
    got = api.random_statements(cn.SECP256K1, 3, seed=seed)
    want = ref_api.random_statements(ref_cn.SECP256K1, 3, seed=seed)
    assert [(s.msg, s.r, s.s, s.pk.x, s.pk.y) for s in got] == \
        [(s.msg, s.r, s.s, s.pk.x, s.pk.y) for s in want]


# ---------------------------------------------------------------------------
# circuit build and witness
# ---------------------------------------------------------------------------

def test_demo_circuit_build_equals_reference(demo):
    assert same_circuit(*demo) == []


def test_nonnative_circuit_build_equals_reference(nonnative):
    assert same_circuit(*nonnative) == []


def test_secp256k1_circuit_build_equals_reference(secp):
    ref_sys, sys_ = secp
    assert same_circuit(ref_sys.circuit, sys_.circuit) == []
    assert sys_.n == 1 << 13 and sys_.gate_counts() == ref_sys.gate_counts()
    lk = data_mod._lookup_info(sys_.circuit)
    assert np.array_equal(data_mod.fixed_values_of(sys_.circuit, lk)[:-1],
                          np.concatenate([ref_sys.circuit.constants, ref_sys.circuit.selectors,
                                          ref_sys.circuit.sigmas]))


def test_demo_witness_equals_reference(demo):
    ref_c, c = demo
    W, pis = examples.small_demo_witness(c, 3)
    ref_W, ref_pis = ref_examples.small_demo_witness(ref_c, 3)
    assert np.array_equal(W, ref_W) and np.array_equal(pis, ref_pis)
    assert check_constraints(c, W, pis) == {}
    bad = W.copy()
    bad[0, int(c.pos_rows[0]), 0] ^= np.uint64(1)
    assert check_constraints(c, bad, pis, raise_on_fail=False) != {}


@pytest.mark.parametrize("native", [True, False])
def test_nonnative_witness_equals_reference(nonnative, native):
    ref_c, c = nonnative
    inputs = _nonnative_inputs()
    vals = c.value_table(inputs, 2, native)
    assert c.last_tape_native is native
    assert np.array_equal(vals, ref_c._run_tape(inputs, 2, native))
    assert np.array_equal(c.public_input_values(), ref_c.public_input_values())
    assert np.array_equal(c.generate_witness(inputs, 2, native),
                          ref_c.generate_witness(inputs, 2, native))


def test_secp256k1_witness_equals_reference(secp):
    ref_sys, sys_ = secp
    stmts = api.random_statements(cn.SECP256K1, 2, seed=3)
    ref_stmts = ref_api.random_statements(ref_cn.SECP256K1, 2, seed=3)
    vals, pis = sys_.witness_vals(stmts)
    ref_vals, ref_pis = ref_sys.witness_vals(ref_stmts)
    assert sys_.circuit.last_tape_native
    assert np.array_equal(vals, ref_vals) and np.array_equal(pis, ref_pis)
    assert np.array_equal(prover._narrow_mask(sys_.circuit), ref_prover._narrow_mask(ref_sys.circuit))


def test_wide_config_circuit_build_and_constraints():
    """wide_ecc_config (234 wires, 176 routed), which the command line's
    --config wide reaches: the secp256k1 circuit builds to the reference's,
    gives the reference's witness, and every constraint holds."""
    ref_sys = ref_api.EcdsaProverSystem(ref_cn.SECP256K1, RefConfig.wide_ecc_config())
    sys_ = api.EcdsaProverSystem(cn.SECP256K1, CircuitConfig.wide_ecc_config(), device="cpu")
    cfg = sys_.circuit.config
    assert (cfg.num_wires, cfg.num_routed_wires) == (234, 176)
    assert same_circuit(ref_sys.circuit, sys_.circuit) == []
    assert sys_.num_rows == ref_sys.num_rows and sys_.gate_counts() == ref_sys.gate_counts()
    stmts = api.random_statements(cn.SECP256K1, 2, seed=9)
    vals, pis = sys_.witness_vals(stmts)
    ref_vals, ref_pis = ref_sys.witness_vals(ref_api.random_statements(ref_cn.SECP256K1, 2, seed=9))
    assert np.array_equal(vals, ref_vals) and np.array_equal(pis, ref_pis)
    assert sys_.check(stmts)
    assert np.array_equal(prover._narrow_mask(sys_.circuit), ref_prover._narrow_mask(ref_sys.circuit))


def test_api_helpers_equal_reference(secp):
    ref_sys, sys_ = secp
    rng = np.random.default_rng(4)
    xs = [int.from_bytes(rng.bytes(32), "little") for _ in range(5)] + [0, (1 << 261) - 1]
    assert api.limbs_to_int(api.int_to_limbs(xs)) == xs == ref_api.limbs_to_int(
        ref_api.int_to_limbs(xs))
    assert sys_.num_rows == ref_sys.num_rows
    stmts = api.random_statements(cn.SECP256K1, 2, seed=9)
    assert sys_.check(stmts)
    assert not sys_.check([stmts[0], api.EcdsaStatement(msg=stmts[1].msg ^ 1, r=stmts[1].r,
                                                        s=stmts[1].s, pk=stmts[1].pk)])

    class Recorder:
        def prove(self, batch):
            return ("proved", batch)

    assert api.prove_ecdsa_batch(Recorder(), stmts) == ("proved", stmts)   # system.prove(stmts)


def test_native_tape_build_failure_raises(monkeypatch, tmp_path):
    from plonky2_ecdsa_tpu_torch import native

    broken = tmp_path / "witness_ops.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "BUILD", str(tmp_path / "build"))
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.get_lib()
    finally:
        native.get_lib.cache_clear()


# ---------------------------------------------------------------------------
# fixed data, and the state carried across
# ---------------------------------------------------------------------------

def _ref_build(ref_c, monkeypatch):
    monkeypatch.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    return ref_data_mod.build_circuit_data(ref_c)


def _assert_same_data(data, arrays):
    for name in ("n", "N", "g", "num_constraint_slots", "perm_slots"):
        assert getattr(data, name) == arrays[name], name
    for name in ("fixed_values", "id_encodings", "x_lde", "zh_inv", "l0_lde"):
        assert np.array_equal(getattr(data, name), arrays[name]), name
    assert np.array_equal(gl.to_u64(data.fixed_coeffs), arrays["fixed_coeffs"])
    assert np.array_equal(gl.to_u64(data.fixed_lde), arrays["fixed_lde"])
    assert data.fixed_tree.cap_height == arrays["cap_height"]
    assert len(data.fixed_tree.levels) == len(arrays["fixed_levels"])
    for got, want in zip(data.fixed_tree.levels, arrays["fixed_levels"]):
        assert np.array_equal(gl.to_u64(got), want)


def test_demo_fixed_data_equals_reference(demo, monkeypatch):
    ref_c, c = demo
    arrays = reference_data_arrays(_ref_build(ref_c, monkeypatch))
    _assert_same_data(data_mod.build_circuit_data(c, "cpu"), arrays)


def test_nonnative_fixed_data_equals_reference(nonnative, monkeypatch):
    ref_c, c = nonnative
    ref_data = _ref_build(ref_c, monkeypatch)
    data = data_mod.build_circuit_data(c, "cpu")
    _assert_same_data(data, reference_data_arrays(ref_data))
    assert (data.lookup.mult_col, data.lookup.table_idx, data.lookup.num_batches,
            data.lookup.cols_per_challenge, data.lookup.slots) == \
        (ref_data.lookup.mult_col, ref_data.lookup.table_idx, ref_data.lookup.num_batches,
         ref_data.lookup.cols_per_challenge, ref_data.lookup.slots)
    assert [gi for gi, _g in data.lookup.gates] == [gi for gi, _g in ref_data.lookup.gates]


def test_data_from_reference_proves_like_native_build(nonnative, monkeypatch):
    """The reference's state carried across as plain arrays, and the port's
    own build, are the same state: field by field, and through a proof that
    also equals the reference's own."""
    ref_c, c = nonnative
    ref_data = _ref_build(ref_c, monkeypatch)
    carried = data_mod.circuit_data_from_reference(c, reference_data_arrays(ref_data), "cpu")
    native = data_mod.build_circuit_data(c, "cpu")
    _assert_same_data(carried, reference_data_arrays(ref_data))
    inputs = _nonnative_inputs()
    W = c.generate_witness(inputs, 2)
    pis = c.public_input_values()
    got = prover.prove(carried, W, pis)
    assert prover.first_difference(prover.prove(native, W, pis), got) is None
    ref_W = ref_c.generate_witness(inputs, 2)
    want = from_reference_proof(ref_prover.prove(ref_data, ref_W, ref_c.public_input_values()))
    assert prover.first_difference(want, got) is None


def test_gate_degree_above_blowup_is_refused(demo):
    _ref_c, c = demo
    gate = c.gates[0]
    old = type(gate).degree
    try:
        type(gate).degree = 9
        with pytest.raises(ValueError, match="degree 9"):
            data_mod.build_circuit_data(c, "cpu")
    finally:
        type(gate).degree = old


def test_in_circuit_gate_evaluation_is_not_carried(demo):
    """Named from before the package carried circuit.recursion, when
    Gate.eval_circuit raised; it now checks that in-circuit evaluation is
    carried: every gate of the demo circuit evaluates in-circuit to the same
    circuit as the reference's, with the same value table."""
    from plonky2_ecdsa_tpu.circuit.builder import CircuitBuilder as RefBuilder
    from plonky2_ecdsa_tpu.circuit.recursion import add_virtual_ext as ref_ext
    from plonky2_ecdsa_tpu_torch.circuit.builder import CircuitBuilder
    from plonky2_ecdsa_tpu_torch.circuit.recursion import add_virtual_ext

    def build(builder_cls, config, ext, gate):
        b = builder_cls(config)
        wires = [ext(b) for _ in range(gate.num_wires)]
        consts = [ext(b) for _ in range(config.num_constant_cols)]
        b.register_input("w", [t for e in wires + consts for t in e])
        ctx = {"pi_vals": [ext(b) for _ in range(8)]}
        for e in gate.eval_circuit(b, wires, consts, ctx):
            b.register_public_inputs(e)
        return b.build()

    rng = np.random.default_rng(12)
    for ref_gate, gate in zip(demo[0].gates, demo[1].gates):
        if gate.num_constraints == 0:
            continue
        c = build(CircuitBuilder, CircuitConfig.test_config(), add_virtual_ext, gate)
        rc = build(RefBuilder, RefConfig.test_config(), ref_ext, ref_gate)
        assert same_circuit(rc, c) == [], gate.gate_id()
        w = {"w": rng.integers(0, gl.P, (1, len(c.inputs["w"])), dtype=np.uint64)}
        assert np.array_equal(c.value_table(w, 1), rc._run_tape(w, 1, None)), gate.gate_id()
