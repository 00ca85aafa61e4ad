"""The bridge between the reference package and the port, used by the other
test_torch_* files: (lo, hi) u32 pairs <-> u64, the reference's Proof <-> the
port's host Proof, the port's CircuitConfig -> the reference's, and the
reference's CircuitData as the plain arrays that
``circuit_data_from_reference`` takes.  The port itself knows nothing of the
reference; only the tests hold the two side by side.  The tests below check
the bridge itself (round trips, tolerance 0)."""

import dataclasses

import numpy as np

from plonky2_ecdsa_tpu.circuit import config as ref_config
from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import fri as ref_fri
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import fri, prover


def pair_to_u64(pair) -> np.ndarray:
    return ref_gl.to_u64(np.asarray(pair[0]), np.asarray(pair[1]))


def u64_to_pair(a):
    return ref_gl.from_u64(np.asarray(a, np.uint64))


def tensor_to_pair(t):
    return u64_to_pair(gl.to_u64(t))


def pair_to_tensor(pair, device="cpu"):
    return gl.from_u64(pair_to_u64(pair), device)


def to_reference_config(cfg):
    """The port's CircuitConfig as the reference's (the same fields)."""
    fields = dataclasses.asdict(cfg)
    return ref_config.CircuitConfig(**{**fields, "fri": ref_config.FriConfig(**fields["fri"])})


def _is_pair(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], np.ndarray)
            and x[0].dtype == np.uint32)


def _pairs_to_u64(x):
    """Every (lo, hi) pair of a nesting -> one u64 array."""
    if _is_pair(x):
        return pair_to_u64(x)
    if isinstance(x, tuple):
        return tuple(_pairs_to_u64(v) for v in x)
    if isinstance(x, list):
        return [_pairs_to_u64(v) for v in x]
    if isinstance(x, dict):
        return {k: _pairs_to_u64(v) for k, v in x.items()}
    return x


def _layout(layout, cls):
    return cls(num_fixed=layout.num_fixed, num_wires=layout.num_wires,
               num_zs_partials=layout.num_zs_partials, num_quotient=layout.num_quotient)


def from_reference_proof(p) -> prover.Proof:
    """The reference's host Proof -> the port's host Proof (u64, int64 indices)."""
    fp = p.fri_proof
    h = _pairs_to_u64
    return prover.Proof(
        pis=np.asarray(p.pis, np.uint64), wires_cap=h(p.wires_cap), zs_cap=h(p.zs_cap),
        quotient_cap=h(p.quotient_cap), openings0=h(p.openings0), openings1=h(p.openings1),
        fri_proof=fri.FriProof(
            caps=h(fp.caps), final_coeffs=h(fp.final_coeffs),
            indices=np.asarray(fp.indices).astype(np.int64), layer_leaves=h(fp.layer_leaves),
            layer_paths=h(fp.layer_paths), pow_witness=h(fp.pow_witness)),
        initial_leaves=h(p.initial_leaves), initial_paths=h(p.initial_paths),
        layout=_layout(p.layout, prover.OpeningLayout))


def to_reference_proof(p) -> ref_prover.Proof:
    """The port's host Proof -> the reference's (u32 pairs, int32 indices)."""
    fp = p.fri_proof
    h = lambda x: prover._map_leaves(u64_to_pair, x)          # noqa: E731
    return ref_prover.Proof(
        pis=np.asarray(p.pis, np.uint64), wires_cap=h(p.wires_cap), zs_cap=h(p.zs_cap),
        quotient_cap=h(p.quotient_cap), openings0=h(p.openings0), openings1=h(p.openings1),
        fri_proof=ref_fri.FriProof(
            caps=h(fp.caps), final_coeffs=h(fp.final_coeffs),
            indices=np.asarray(fp.indices).astype(np.int32), layer_leaves=h(fp.layer_leaves),
            layer_paths=h(fp.layer_paths), pow_witness=h(fp.pow_witness)),
        initial_leaves=h(p.initial_leaves), initial_paths=h(p.initial_paths),
        layout=_layout(p.layout, ref_prover.OpeningLayout))


def reference_data_arrays(ref_data) -> dict:
    """The reference's CircuitData as plain numpy u64 arrays and Python ints."""
    return dict(
        n=ref_data.n, N=ref_data.N, g=ref_data.g,
        num_constraint_slots=ref_data.num_constraint_slots, perm_slots=ref_data.perm_slots,
        fixed_values=np.asarray(ref_data.fixed_values, np.uint64),
        fixed_coeffs=pair_to_u64(ref_data.fixed_coeffs),
        fixed_lde=pair_to_u64(ref_data.fixed_lde),
        fixed_levels=[pair_to_u64(lv) for lv in ref_data.fixed_tree.levels],
        cap_height=ref_data.fixed_tree.cap_height,
        id_encodings=np.asarray(ref_data.id_encodings, np.uint64),
        x_lde=np.asarray(ref_data.x_lde, np.uint64),
        zh_inv=pair_to_u64(ref_data.zh_inv), l0_lde=pair_to_u64(ref_data.l0_lde))


def same_circuit(ref_c, c) -> list:
    """Names of the build outputs in which the reference's circuit and the
    port's differ (empty when the two builds are the same circuit)."""
    bad = []
    for name in ("constants", "sigmas", "selectors", "row_gate_idx", "pos_rows", "pos_cols",
                 "pos_tids", "read_map", "pi_tids", "derived_tids"):
        if not np.array_equal(getattr(ref_c, name), getattr(c, name)):
            bad.append(name)
    for name in ("n", "num_targets", "k_coeffs", "lookup_mult_col", "constant_values"):
        if getattr(ref_c, name) != getattr(c, name):
            bad.append(name)
    if [g.gate_id() for g in ref_c.gates] != [g.gate_id() for g in c.gates]:
        bad.append("gates")
    if (ref_c.pi.rows, ref_c.pi.num_cols, ref_c.pi.count) != (c.pi.rows, c.pi.num_cols, c.pi.count):
        bad.append("pi layout")
    if sorted(ref_c.inputs) != sorted(c.inputs) or any(
            not np.array_equal(ref_c.inputs[k], c.inputs[k]) for k in c.inputs):
        bad.append("inputs")
    if sorted(ref_c.range_layouts) != sorted(c.range_layouts) or any(
            ref_c.range_layouts[k][:3] != c.range_layouts[k][:3]
            or not np.array_equal(ref_c.range_layouts[k][3], c.range_layouts[k][3])
            for k in c.range_layouts):
        bad.append("range_layouts")
    return bad


def test_pair_round_trip():
    rng = np.random.default_rng(9)
    a = rng.integers(0, gl.P, (5, 7), dtype=np.uint64)
    a[0, 0], a[0, 1] = 0, gl.P - 1
    lo, hi = tensor_to_pair(gl.from_u64(a))
    assert lo.dtype == np.uint32 and hi.dtype == np.uint32
    assert np.array_equal(pair_to_u64((lo, hi)), a)
    assert np.array_equal(gl.to_u64(pair_to_tensor((lo, hi))), a)


def test_proof_round_trip_keeps_every_leaf():
    rng = np.random.default_rng(10)

    def r(*shape):
        return rng.integers(0, gl.P, shape, dtype=np.uint64)

    p = prover.Proof(
        pis=r(2, 4), wires_cap=r(2, 2, 4), zs_cap=r(2, 2, 4), quotient_cap=r(2, 2, 4),
        openings0=(r(2, 9), r(2, 9)), openings1=(r(2, 2), r(2, 2)),
        fri_proof=fri.FriProof(caps=[r(2, 2, 4)], final_coeffs=(r(2, 4), r(2, 4)),
                               indices=rng.integers(0, 32, (2, 3)),
                               layer_leaves=[r(2, 3, 4)], layer_paths=[r(2, 3, 3, 4)],
                               pow_witness=r(2)),
        initial_leaves={"fixed": r(2, 3, 5)}, initial_paths={"fixed": r(2, 3, 4, 4)},
        layout=prover.OpeningLayout(3, 3, 2, 1))
    back = from_reference_proof(to_reference_proof(p))
    assert prover.first_difference(p, back) is None
    assert prover.proof_digest(p) == prover.proof_digest(back)
    assert to_reference_proof(p).fri_proof.indices.dtype == np.int32
    back.openings1[1][1, 1] ^= np.uint64(1)
    assert prover.first_difference(p, back) == "openings1[1]"
    assert prover.proof_digest(p) != prover.proof_digest(back)


def test_outer_circuit_data_converts_to_the_ports_own(monkeypatch):
    """The demo recursion's outer CircuitData (a rate-8 verifier circuit with
    PoseidonGate rows) from the reference, through reference_data_arrays and
    circuit_data_from_reference, equals the port's own build array for array;
    so a proof of either side can be checked against the other's data."""
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data, circuit_data_from_reference
    from test_torch_recursive_proof import OUTER, port_inner, ref_inner, ref_outer_circuit

    _ic, idata, _ip = port_inner(2, 77)
    _ric, ridata, _rip = ref_inner(2, 77, monkeypatch)
    oc = rv.verifier_circuit(idata, OUTER)
    roc = ref_outer_circuit(ridata)
    assert same_circuit(roc, oc) == []
    arrays = reference_data_arrays(ref_data_mod.build_circuit_data(roc))
    got = circuit_data_from_reference(oc, arrays, "cpu")
    own = build_circuit_data(oc, "cpu")
    assert (got.n, got.N, got.g, got.num_constraint_slots, got.perm_slots, got.lookup) == \
        (own.n, own.N, own.g, own.num_constraint_slots, own.perm_slots, None)
    for name in ("fixed_values", "id_encodings", "x_lde", "zh_inv", "l0_lde"):
        assert np.array_equal(getattr(got, name), getattr(own, name)), name
    for name in ("fixed_coeffs", "fixed_lde"):
        assert np.array_equal(gl.to_u64(getattr(got, name)), gl.to_u64(getattr(own, name))), name
    assert len(got.fixed_tree.levels) == len(own.fixed_tree.levels)
    for a, b in zip(got.fixed_tree.levels, own.fixed_tree.levels):
        assert np.array_equal(gl.to_u64(a), gl.to_u64(b))
